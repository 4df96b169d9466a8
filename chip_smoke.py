#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and excused):

1. Build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one compiler per source, all at once.  Print each
   kernel's registers and spills from ptxas; for K7/K8 also the shared
   memory, and the HGMMA (wgmma) and HMMA instructions in its SASS where
   cuobjdump exists: the bf16 kernels must hold HGMMA, the f32 ones none
   (head widths 16, 32, 64, 96, 128 and 256).  The bf16 kernels with a
   design of their own at one width (``SPILL_FREE_KERNELS``: the forward
   at head_dim 256, ``flash_fwd_wide_tc``; the backward at 256,
   ``flash_dq_wide_tc`` and ``flash_dkv_wide_tc``, and at 96,
   ``flash_dq_full_tc`` and ``flash_dkv_full_tc``), in both builds, must
   report no spill bytes and no ptxas "Performance Loss" line.  The
   flash source compiles while phase 2 checks K1-K5 and phases 3 and 5
   train (neither runs a flash kernel).
2. Hold each kernel against its plain torch version on the card.  K1–K3
   at a 1 Mi-element bucket, a ragged n, phase 3's largest hop (16, 960,
   2560) and phase 6's (393,216,000 elements, the first RHD hop of
   gemma's tied embedding), bit for bit; K5 within 1 ulp at the same
   small sizes, smollm-360m's largest leaf and gemma's tied embedding
   (786,432,000 elements, out of place and in place); plus the
   subnormal regime against
   the plain version on a CPU copy under the flush-to-zero guard, and
   e4m3 values that round up to exactly 448.  Every path of K2 and K5:
   views 4, 8 and 12 bytes into a 1 Mi buffer (their scalar loops, which
   must be counted in ``scalar_launches``), n of 1 to 33 (the ragged
   tail), K5 in place (aligned, and with a misaligned g), and bf16 NaN,
   +-inf and -0.  K4 bit for bit at the
   largest ResNet-50 bucket (4, 2359296) f32, ragged and vector-width
   bf16 cases, the [1024, 1, ..., 1] bf16 column (k = 256, exactly
   1279) and integer-valued ragged rows (exact), and subnormals.  K6 at phase 4's
   (4096, 960) rows and a ragged (37, 960), f32 within rtol 1e-5 and
   bf16 within 1 ulp, and the same at phase 6's width 3072; then one row,
   widths 2048, 1000, 1001 and 7 and a view one element into its
   storage, on the path expected (``scalar_launches``).  K7/K8
   causal at phase 4's (1, 4096, 15, 64) and phase 6's (1, 4096, 16, 256)
   in f32 and bf16, plus window 100, non-causal and other head widths at
   ragged S (dh 256 at S = 64, 333 and 513, and window 1024 at 4096), at
   the reference's tolerances; each bf16 case twice, bit for bit.  K8's
   ``rowsum(dO*O)`` kernel against ``_delta`` per row within
   dh·2⁻²⁴·Σ|dO∘O| at every head width in f32 and bf16, S 333 and 4096,
   on aligned views and on f32 views off a 16-byte boundary.
   Times each kernel, its plain version
   and, where one exists, one PyTorch call computing the same function
   (a yardstick the port never calls); K1–K3 take their inputs in turn
   from three buffers larger than L2, K2 also as its int8/fp8 quantize
   pass alone; K1–K3 (int8) and K5 also at phase 6's hop and leaf
   (``variants``); each kernel in turns with its yardstick; K7/K8 in bf16
   (tensor cores, the main path) and in f32 (CUDA cores, against the
   f32 peak), at dh 64, 256 and 96 (``variants``), and K8 bf16 at dh 96
   and 256 also split into its parts: the rowsum(dO*O) kernel (at dh 64
   too, beside ``_delta``), the dq pass and the dk/dv pass, each alone;
   K6 also at (4096, 3072) and (4096, 4096) (zamba2's shared block).
3. Train full-width smollm-360m (32 layers, d_model 960, ~362 M
   parameters, bf16 compute) on 4 ranks sharing this card over gloo,
   batch 2 per rank, seq 512, ``rhd_rsa`` + ``int8`` fused hops and the
   K5 AdamW, for 3 steps through ``Trainer``.  Every launch count is
   reset just before and read just after; K1–K3, K5 and K6 must have
   run, losses must be finite and parameters bit-identical on every
   rank; the launches of K2 and K5 that took their scalar loops are
   printed.  Then the same ranks train a small float32 model (seq 32) on
   the card and on the host's plain versions, and the two must agree.
4. Long context: the same model at seq 4096 (above its
   ``attn_full_seq_max`` of 2048, so attention takes K7/K8) on 2 ranks
   sharing the card over gloo, batch 1 per rank, 2 steps; K6/K7/K8 must
   have run (K7 and K8 once per layer per step), losses finite and
   parameters bit-identical; then a small float32 model at seq 128 (its
   flash path) on the card and on the host must agree.
5. (Run after phase 3, while the flash source still compiles.)  The
   paper's CNNs: full-width ResNet-50 (psum, ring_rsa, rhd_rsa and
   ps_gather with fused hops, whose terminal sum is K4) and MobileNet-v1
   (rhd_rsa and fused ps_gather) at 224x224, 1000 classes, bf16 compute,
   on 4 ranks sharing the card over gloo, global batch 128 (32 per
   rank), SGD ``p - 0.05 g``: one warm-up step and 2 timed steps per
   model and strategy through ``Trainer``, spawned once.  K4 must launch
   exactly once per bucket per step under fused ps_gather (21 on
   ResNet-50, 5 on MobileNet-v1) and never otherwise; losses finite,
   parameters bit-identical on every rank.  Then a small float32
   MobileNet-v1 at image 32 under fused ps_gather on the card and on the
   host's plain versions must agree.
6. Long context at gemma-7b's full width (d_model 3072, 16 heads of
   256, d_ff 24576, vocab 256000, GeGLU, scaled tied embeddings), depth
   cut to ``GEMMA_LAYERS`` of 28 so that two f32 replicas with their
   AdamW state fit one card: seq 4096 on 2 ranks sharing the card over
   gloo, batch 1 per rank, 2 steps, ``rhd_rsa`` + ``int8`` fused hops,
   K5, bf16 compute, through ``Trainer`` and ``build_trainer``.  K1–K3
   and K5–K8 must launch (K7 and K8 once per layer per step, at head_dim
   256), losses be finite, parameters bit-identical, and the memory the
   whole card holds at the end of the main path (every process's
   context, its allocator's reserved blocks and workspaces) be at most
   90% of the card's; then a float32 gemma
   (``reduced()`` with head_dim kept at 256) at seq 128 trains on the
   card and on the host's plain versions, which must agree.
7. The transport: phase 3's smollm-360m and phase 6's gemma-7b again on
   ``cuda_ipc`` (payloads copied device to device into receive slots
   the peers mapped once; each hop's notify and acknowledgement a
   counter the card waits on, ``csrc/mailbox.cu``), each rank's
   parameters bit-identical to phases 3 and 6; phase 5's ResNet-50
   (ring_rsa, rhd_rsa, fused ps_gather) and MobileNet-v1 (rhd_rsa, fused
   ps_gather) on gloo and on ``cuda_ipc`` in one spawn, under cuDNN's
   deterministic algorithms (phase 5 keeps the default ones, which
   differ from run to run), each rank's parameters bit-identical across
   the two.  K1-K5 must launch as often as on gloo, phase 6's card stay
   within 90%, and no aggregate stage a byte through the host
   (``tests/test_torch_transport_on_card.py``, the transport's
   primitives against gloo on the card, 37-42 s, runs apart; phase
   11(f) holds the same hops to gloo here).  Prints both
   transports' step, aggregate and images/s beside the card, and phase
   5's images/s beside phase 7's gloo run (the cost of deterministic
   cuDNN).

8. ``strategy="auto"`` and ``overlap=True``: phase 7's smollm-360m on
   ``cuda_ipc`` + ``int8`` with each bucket reduced inside the backward
   on a channel of its own (``AggregatorConfig(overlap=True)``).  Under
   ``rhd_rsa`` each rank's parameters and K1-K5 launches must equal
   phase 7's cuda_ipc run.  Under ``strategy="auto"`` with a tuning
   table that picks ``rhd_rsa`` below 64 MiB and ``ring_rsa`` above, so
   that one backward runs both algorithms through slots sized for both,
   the per-bucket algorithms must equal a host ``plan()`` of the same
   tree and table, and each rank's parameters and launches must equal a
   post-backward run of the same schedule.  No channel may stage a byte
   through the host.  Then phase 7's ResNet-50 ``rhd_rsa`` on
   ``cuda_ipc`` with ``overlap=True`` under deterministic cuDNN, bit for
   bit to phase 7's, every rank's first bucket reduction starting before
   its backward ends (smollm's buckets, stacked over the layers or
   holding the tied embedding, complete only at the end of backward, so
   there it is printed, not required).  Prints each bucket's ready,
   start and end times, hidden and exposed communication, the measured
   overlap fraction beside ``overlap.simulate``'s (fed with the measured
   ready and communication times), and the step times beside phase 7's.

9. Two dp axes: full-width smollm-360m on the 4 ranks laid out as a
   2 (pod) x 2 (data) mesh (``launch/mesh.py``'s groups, pod major),
   ``ring_rsa×rhd_rsa`` (ring reduce-scatter inside a pod, RHD of the
   half across pods, ring all-gather) with the per-level codec
   ``bf16×int8`` and fused hops, K5, 3 steps per run in one spawn: on
   gloo, on ``cuda_ipc`` (a channel per axis, each sized to its axis's
   largest hop) and on ``cuda_ipc`` overlapped, each rank's parameters
   and K1-K5 launches equal across the three; then ``strategy="auto"``
   under a forced two-axis table (the flat RHD fold below 64 MiB, the
   composed schedule above), overlapped and post-backward, its buckets
   as a host ``plan()`` chose them and bit for bit to each other.  K1-K3
   must launch each step exactly as the plan's hops imply, K5 and K6
   must run, losses be finite, parameters bit-identical on every rank,
   and no cuda_ipc aggregate stage a byte through the host.  Step 1's
   gradient under the composed schedule must lie within both
   schedules' bound (``codec.tolerance`` per level) of flat ``rhd_rsa``
   + int8's on the same inputs.  Prints each run's steps, plan, hops
   per bucket per axis, and its aggregate timed alone beside phase 7's
   and beside flat ``rhd_rsa`` + int8 on the same gradient.  Then
   ResNet-50 (224x224, global batch 128, SGD) on the same mesh under
   ``ring_rsa×rhd_rsa`` uncoded, 2 steps on gloo and 2 on ``cuda_ipc``
   under deterministic cuDNN: each rank's parameters bit for bit across
   the two transports and across ranks, no kernel launched.

10. The model axis: full-width smollm-360m on the 4 ranks laid out as
   data 2 x model 2 (``--mesh 2x2`` through ``build_trainer``; model
   ranks consecutive, ``launch/mesh.py``), each rank holding its shards
   of the model-sharded leaves and gathering them at the loss
   (``core/manual.py``), global batch 8, 3 K5 AdamW steps per run, in
   one spawn: uncoded ``rhd_rsa`` on gloo and on ``cuda_ipc``
   (replicated buckets bracketed, ``rhd@data×ag@model``; a channel for
   the model axis), bit for bit to each other, each step's global norm
   too; the gathered parameters bit-identical on all 4 ranks; then
   ``rhd_rsa`` + ``int8`` fused hops on ``cuda_ipc`` (the codec skips
   the bracket).  K1-K3 must launch each step as the plan's hops imply,
   K5 once per leaf and K6 as in phase 3; no cuda_ipc aggregate or
   gather stage a byte through the host.  Then two data-only runs of
   the same batch on 2 ranks.  The witness is clipped by the uncoded
   cuda_ipc run's norms: step 1's aggregated gradient and the
   parameters after 3 steps must equal that run's shards bit for bit
   (both read through the step's ``inspect``), and the witness's own
   norm of each step must be within 4 ulps of the sharded one.  The
   data-only run as it is differs from the witness only by its norm's
   last bit: what its 3 steps changed is printed against the
   witness's, read with the reference wall's rtol 1e-3 / atol 5e-5.
   Then a small float32 model at the same mesh on the card and on the
   host must agree.  Prints the steps,
   the plan, the model group's all-gather bytes, peak memory per rank
   beside phase 3's and the layers timed alone.

11. Telemetry: one 4-rank ``cuda_ipc`` spawn with ``REPRO_TRACE=1`` in the
   ranks.  (a) Phase 7's smollm-360m (seq 512, ``rhd_rsa`` + ``int8``
   fused hops, K5 AdamW, 3 steps): each rank's parameters and
   K1/K2/K3/K5/K6 launches per step must equal phase 7's (telemetry off);
   every stage and bucket path of the executed schedule must have one
   ``trace`` span per step with the IR's wire bytes and algorithm, each
   stage as many hop spans as the plan's hops; each step's hop log
   (what the transport sent on each hop, ``analysis/hop_lint.py``) must
   lint clean against the schedule, no error and no unbaselined warning,
   each stage's hops must have sent exactly the IR's bytes with one
   scale per encoded block (``hop_lint.exact_sent_bytes``), and its
   bytes must account for the bytes written through the mappings;
   ``train_step_s`` must hold 3 samples.
   Prints per step the host ms in hop spans, in stage spans outside
   hops and in bucket spans outside stages.  (c) The closure on that
   schedule: every stage replayed alone on the group (``measure_schedule``,
   3 reps), k finite and positive; prints k per axis size, max_ratio,
   the band verdict (declared for host-CPU replays, not required), the
   measured and predicted overlap fractions, and the fused replay (K1-K3)
   against the unfused route.  (b) Phase 8's overlapped ResNet-50: each
   rank's parameters equal phase 8's, every bucket's spans on the
   channel's thread, the hop lint clean with HL002 (a whole bucket's
   hops issued before the backward ends); prints each bucket's channel
   time split into hops, stages and the rest beside its ready/start/end
   times, and per rank and step the hops' issue time (no host wait in a
   hop on the card), the host's one wait for the channel at the
   backward's join, and on the card's clock (CUDA events) the buckets
   that ended before the backward's last kernel and the device overlap
   fraction (printed, not gated).  (e) Phase 8's overlapped smollm-360m,
   2 steps: the hop lint clean, HL002's witness printed, not required
   (its stacked leaves complete at the end of backward).  (d) Rank 0's
   trace file must reload through ``trace.from_json``.  Prints, per
   stage, the IR's bytes beside the bytes the hops sent.  (f) The
   channel's waits on the card (``ipc_wait``, a row of the JSON record's
   ``transport`` list, not of ``kernels``: it is no kernel and replaces
   no Pallas kernel, and a hop's time is a latency that no byte or
   operation count bounds): ring hops of mixed sizes back to back (more
   than ``SLOTS``), an all-gather, ``rhd_rsa`` and ``ring_rsa`` on a 1 Mi-element bucket,
   each through a channel of its own, bit for bit gloo's, and every
   channel must have enqueued waits on the card, as must (a), (b) and
   (e); then a 4 KiB ring hop timed on the card's clock beside gloo's.

In phases 3-11 the executors must be built once each by the end of step
1, and neither rebuilt nor added to later; the plan cache must only hit
from step 2.  In phases 3, 4, 6, 7, 9 and 10 K1-K3 must launch each step
as the plan's hops imply (``_plan_hop_launches``; a scaled codec encodes
each chunk an RHD forwarding hop joins at its own scale).  One aggregate
is profiled, on every rank of phase 7's smollm-360m (the profiler's
start-up took 11.8-18.6 s a spawn on the H100, so no other training
spawn profiles; every aggregate's host staging is counted by
``dist.traffic``), and
split into copies host<->device and device<->device, K1-K3/K4, gloo
waits and the channel's waits (on the card only its sync at the
aggregate's end); it must copy nothing between host and card.

12. Serving (the reference's ``serve/`` and KV-cache decode).  (a)
   Full-width, full-depth gemma-7b (28 layers, 8,537,680,896 f32
   parameters from a seeded generator on the card, bf16 compute) in
   this process through ``launch/serve.py::build_engine`` and
   ``ServeEngine``: batch 2, prompt 4096, 32 greedy tokens.  K7 must
   launch 28 times in prefill and never in decode, K6 57 times per
   forward; the tokens in range, the decode logits finite; decode must
   equal forward (prefill 4096 of a 4104-token batch, 8 teacher-forced
   steps, the last logits within a relative 0.05 of ``forward`` over all
   4104, the reference's criterion); the card at most 90% full.  Prints
   prefill seconds, decode ms per token, tokens/s, peak memory, the
   decode step's cast-bound under the reference's design (f32 weights
   read, their bf16 cast written and read, the KV cache read) and its
   own floor (f32 weights read once, the cache read) beside it, and the
   casts alone; the prompt's tokens must be in range on the card before
   the embedding lookup (counted there into host memory, readable after
   a device-side assert).
   (b) The float32 gemma (``reduced()``, head_dim 256) at prompt 128 on
   the card and on the host's plain versions: prefill logits within K7's
   f32 tolerance, 16 greedy tokens equal.  (c) Full-width smollm-360m on
   4 ``cuda_ipc`` ranks as data 2 × model 2 (``--mesh 2x2``), global
   batch 4, prompt 512, 32 greedy tokens: the gather boundary at every
   prefill and decode step; each data rank's tokens and last logits bit
   for bit a one-rank engine's on its 2 rows with the full parameters
   drawn again from the seed, which the gather boundary's output must
   equal bit for bit, and the model ranks bit for bit each other; prints
   the gather boundary's time per step beside decode ms per token.

13. The rest of the transformer family (MoE, MLA with a dense prefix,
   the VLM backbone; bf16 compute).  (a) Full-width, full-depth
   deepseek-v2-lite-16b (27 layers, 15,706,470,400 f32 parameters drawn
   on the card) served through ``build_engine`` and ``ServeEngine``:
   batch 2, prompt 2048, 32 greedy tokens at the config's capacity
   factor 1.25.  K6 55 times per forward and never a K7 (MLA runs
   outside any kernel), tokens in range before the lookup, finite
   logits, one MoE layer's output twice bit for bit, the card at most
   90% full; decode against forward at capacity factor 8.0 (prefill
   2048 of 2056, 8 teacher-forced steps, relative 0.05): in bf16 printed
   with the routing flips between decode and forward, in float32 (the
   same parameters) held.  Prints prefill s, decode ms per token,
   tokens/s, peak memory, kernels per decode step (profiled) and the
   decode cast-bound and floor.  (b) Full-depth phi-3-vision-4.2b:
   batch 2, 576 patches + 3520 tokens = 4096 positions, 32 greedy
   tokens; K7 at head_dim 96 32 times in prefill and never in decode,
   the engine's cache sized with the patches (F8), decode against
   forward in bf16 held.  (c) granite-moe-1b-a400m at full width on 2
   ``cuda_ipc`` ranks through ``run_phase`` (``rhd_rsa`` + ``int8``, K5
   AdamW, seq 4096, batch 1 per rank, 2 steps), depth cut to
   ``GRANITE_MOE_LAYERS``; (d) phi-3-vision the same, cut to 4 layers,
   576 + 3520 positions (K7/K8 at head_dim 96 on a training path): K7
   and K8 once per layer per step, the card at most 90% full, ``aux``
   and ``drop`` per step printed.  (e) The reduced float32 specs of the
   three at prompt 96 on the card and on the host: prefill logits within
   K7's f32 tolerance, the routing equal, 16 greedy tokens equal.

14. The recurrent and encoder-decoder families (bf16 compute,
   parameters drawn on the card).  (a) Full-width, full-depth
   zamba2-1.2b (38 Mamba2 layers and the shared attention block applied
   6 times; 1,113,328,512 f32 parameters), (b) xlstm-350m (21 mLSTM + 3
   sLSTM, the published sequential scan; 313,119,828) and (c)
   whisper-tiny (4 + 4 layers, LayerNorm, frames (2, 1500, 384);
   36,487,680) served through ``build_engine`` and ``ServeEngine``:
   batch 2, prompts 4096, 512 and 64, 32 greedy tokens.  Per forward K6
   51 times in zamba2 (6 of them at width 4096) and 25 in xLSTM, never in
   whisper; K7 6 times in zamba2's prefill, never in decode nor in xLSTM
   or whisper's serving; tokens in range before the lookup, finite
   logits, the card at most 90% full; decode against forward in bf16
   within 0.05 (zamba2: prefill 3840, 256 teacher-forced steps against
   the forward over 4096; whisper: 8 steps).  xLSTM at full depth with
   random weights amplifies rounding (a matmul of another shape moves
   its logits by O(1) in bf16): its bf16 decode against forward (prefill
   256, 8 steps) is printed, decode = forward held in float32 on the
   reference test's prompt (prefill 8, 4 steps), and ``mlstm_chunk = 64``
   against the sequential scan on one mLSTM layer at full width
   (outputs and the next decode step within 2e-4, states within 1e-4),
   the whole model's chunked prefill printed.  Prints prefill s, decode
   ms per token beside its floor (f32 weights read once plus the cache
   and states at 3.35 TB/s) and one profiled decode step.  (d) The
   three trained on 2 ``cuda_ipc`` ranks through ``run_phase``
   (``rhd_rsa`` + ``int8``, K5, batch 1 per rank, seq 4096, 2 steps):
   zamba2 depth cut to ``ZAMBA2_TRAIN_LAYERS`` (whole groups of 6), K7
   and K8 once per application per step; xlstm-350m with
   ``mlstm_chunk = 64`` (the sequential scan's autograd would keep a
   ``C`` per token), cut to seq 1024 (its sLSTM time loop took 22-27 s a
   step at 4096, 12-17 s at 2048) and to its first 8 layers (7 mLSTM +
   1 sLSTM; all 24 took 50.6 s of the phase); whisper at full depth, K7
   and K8 4 times per step;
   the card at most 90% full, then each reduced float32 spec trained on
   the card and on the host.  (e) The three reduced float32 specs at
   prompt 96 on the card and on the host: prefill logits within K7's
   f32 tolerance, 16 greedy tokens equal.  (f) Phase 4's run with
   ``remat=True`` (K7 twice per layer per step, K8 once): the parameters
   after 2 steps bit for bit phase 4's; both runs' peak memory printed.

15. ``analysis/`` and the planning tools (no device: everything on meta
   tensors or in the host's memory).  (a) ``python -m
   repro_torch.analysis --source --schedules --check-baseline`` in this
   process must return 0 over the 157 schedule cells and the import
   lint.  (b) is phase 11's hop lint.  (c) ``launch/dryrun.py --all``
   on 16x16 and 2x16x16 in a process of its own, started before phase
   12 and run beside phases 12-14 (it needs no card): 80 records, each
   OK or SKIP with the shape policy's reason, every train record statically
   verified, priced on the H100, rendered by ``launch/report.py``.  (d)
   The dry run's memory estimate and roofline at phases 3, 4 and 6's
   own configurations: the exact part (parameters, gradients, AdamW
   moments, inputs) at most each rank's measured peak; the estimate and
   the roofline printed beside the measured peak, forward+backward,
   aggregate and step.  Prints its seconds (budget 60) beside the card's
   name and power limit.

16. The characterization (``experiments/``, ``dryrun --trace``, the
   closure artifact).  (a) ``python -m repro_torch.experiments.regen
   --check`` in this process must return 0 and C1-C10 PASS (printed with
   their values and bands).  (b) The measured backend: the paper's five
   designs on the port's reducers (``matrix.measure_points``, one spawn
   of 4 ranks sharing the card), ResNet-50 and MobileNet-v1 at p = 2 and
   4, on ``cuda_ipc`` and on gloo, every distinct bucket size at full
   size, best of 5 after a warm-up, every sum checked exact; every
   bucket size must have a finite, positive latency.  Prints each row's
   measured comm_s beside the ``paper`` profile's model comm_s, and
   whether every no-gRPC design beat ``gRPC_PS`` (printed, not
   required).  (c) ``dryrun --trace`` on smollm-360m ``train_4k`` on
   16x16 (one arch: a replay spawns 16 ranks and took 38-39 s on the
   H100): 16 ``cuda_ipc`` ranks, each stage on
   a group of its own axis size; prints n_stages, k, max_ratio,
   within_band, the measured overlap beside the predicted one, each
   distinct stage, the replay's memory beside its estimate, and
   ``report.telemetry_table``.  (d) ``python -m
   repro_torch.telemetry.closure --check
   artifacts_torch/telemetry_closure.json`` (8 gloo ranks on the host's
   CPU, where the closure's band was declared) must return 0; the same
   cells measured on 8 ``cuda_ipc`` ranks sharing the card (committed
   beside it) are printed with their max_ratio.  Prints its
   seconds (budget 180) beside the card's name and power limit.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": ...}``.  ``python3 chip_smoke.py
--serve-only`` builds the kernels and runs phase 12 alone, ``--family-only``
phase 13 alone, ``--recurrent-only`` phase 14 alone (with phase 4's run
for (f)), ``--analysis-only`` phases 11 and 15 alone (not held to phases
3-8; (d) then against phase 11's smollm-360m run),
``--characterization-only`` phase 16 alone; the last line is then the
card's name and power limit.
"""
import argparse
import collections
import concurrent.futures
import itertools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TRAIN_WORLD = 4
TRAIN_STEPS = 3
LONG_WORLD = 2
LONG_STEPS = 2
LONG_SEQ = 4096
D_MODEL, HEADS, HEAD_DIM, LAYERS = 960, 15, 64, 32   # smollm-360m
ATTN_SHAPE = (1, LONG_SEQ, HEADS, HEAD_DIM)          # one layer, phase 4
CHECK_N = 1 << 20            # a main-path bucket size (1 Mi f32)
RAGGED_N = 1_000_003
SMALL_N = (1, 3, 4, 5, 7, 8, 15, 16, 17, 31, 33)   # tails alone, one unit + tail
HOP_SHAPE = (16, 960, 2560)  # phase 3: first RHD hop of smollm's d_ff bucket
LEAF_SHAPE = (32, 960, 2560)  # smollm-360m's largest leaf (body/mlp/w1)
R50_BUCKET = 2_359_296       # the largest ResNet-50 bucket (a 3x3x512x512 leaf)
FLASH_SOURCE = "flash_attention"  # built beside phase 2's K1-K5 checks
TURN_REPS = 20                # calls per timed turn of a kernel
HOLD_CYCLES = 100_000_000     # ~50 ms of spinning at the H100's 1.98 GHz
CNN_WORLD = 4
CNN_BATCH = 32 * CNN_WORLD   # global; the paper's 64 per GPU, halved for 4
CNN_IMAGE = 224              # ranks on one card
CNN_WARMUP, CNN_TIMED = 1, 2
CNN_RUNS = (("resnet50", ("psum", "ring_rsa", "rhd_rsa", "ps_gather")),
            ("mobilenet", ("rhd_rsa", "ps_gather")))
CNN_BUCKETS = {"resnet50": 21, "mobilenet": 5}   # at the 4 MiB threshold
GEMMA_WORLD = 2
GEMMA_STEPS = 2
# Depth of phase 6's gemma-7b.  Each rank holds ~20 B per parameter (f32
# weights, gradients, AdamW state, the aggregate's buffers) on
# 786.4 M + 276.8 M per layer, plus the 4096 x 256000 logits and their
# gradient.  On an H100 80GB (79.18 GiB) the card held 64.73 GiB (81.8%)
# at one layer and 78.71 GiB (99.4%) at two (PERF.md section 4).
GEMMA_LAYERS = 1
GEMMA_D = 3072
ZAMBA2_NORM_D = 4096             # zamba2-1.2b's shared-block RMSNorm width
GEMMA_LEAF = (256000, GEMMA_D)   # the tied embedding, one bucket of its own
GEMMA_HOP = (math.prod(GEMMA_LEAF) // GEMMA_WORLD,)  # its first RHD hop
GEMMA_ATTN = (1, LONG_SEQ, 16, 256)                  # one layer, phase 6
PHI3_ATTN = (1, LONG_SEQ, 32, 96)      # one layer of phi-3-vision, phase 13


def log(msg):
    print(msg, flush=True)


_GPU_LINE = []


def gpu_line():
    """The card's name and power limit from ``nvidia-smi``, read once a
    process: the phases print it beside their numbers."""
    if not _GPU_LINE:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        _GPU_LINE.append(out.stdout.strip().splitlines()[0])
    return _GPU_LINE[0]


def time_ms(fn, reps=10):
    """Device milliseconds per call of ``fn``.  A spin kernel holds the
    stream while the calls are enqueued, so the host's launch overhead
    (the ctypes wrappers take tens of microseconds) does not show as
    device time for a kernel shorter than it."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_flops, tensor_cores=False):
    """The least time for the work: bytes over HBM bandwidth or
    operations over the peak (f32 CUDA cores, or dense bf16 tensor
    cores), whichever is larger."""
    from repro_torch.core.hw import H100_SXM
    t_bytes = n_bytes / H100_SXM.hbm_bandwidth
    t_ops = n_flops / (H100_SXM.peak_bf16_flops if tensor_cores
                       else H100_SXM.peak_f32_flops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


CHUNK = 1 << 26    # elements compared at a time: bounds the temporaries


def _chunks(a, b):
    """Matching flat slices of ``a`` and ``b``, both on ``a``'s device."""
    a, b = a.reshape(-1), b.reshape(-1)
    for i in range(0, a.numel(), CHUNK):
        yield a[i:i + CHUNK], b[i:i + CHUNK].to(a.device)


def bits_equal(a, b):
    import torch
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return all(torch.equal(x.view(view), y.view(view))
               for x, y in _chunks(a, b))


def max_abs(a, b):
    return max((float((x.float() - y.float()).abs().max())
                for x, y in _chunks(a, b)), default=0.0)


def max_ulp(a, b):
    import torch

    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return max((int((ordered(x) - ordered(y)).abs().max())
                for x, y in _chunks(a, b)), default=0)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


KERNELS = {   # name -> (source, TPU kernel it replaces)
    "hop_absmax": ("fused_hop.cu", "src/repro/kernels/fused_hop.py:144"),
    "hop_encode": ("fused_hop.cu", "src/repro/kernels/fused_hop.py:153"),
    "hop_decode_add": ("fused_hop.cu",
                       "src/repro/kernels/fused_hop.py:164"),
    "fused_reduce": ("fused_reduce.cu",
                     "src/repro/kernels/fused_reduce.py:26"),
    "adamw_update": ("fused_adamw.cu",
                     "src/repro/kernels/fused_adamw.py:21"),
    "fused_rmsnorm": ("fused_rmsnorm.cu",
                      "src/repro/kernels/fused_rmsnorm.py:19"),
    "flash_attention_fwd": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:29"),
    "flash_attention_bwd": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:129"),
}
# K7/K8's build that takes a query offset (``Sq != Sk`` or ``q_off > 0``:
# a sequence split over the model ranks, phase 17), counted apart
# (``.offset_launches``) and listed as rows of their own.
OFFSET_KERNELS = {"flash_attention_fwd[q_offset]": "flash_attention_fwd",
                  "flash_attention_bwd[q_offset]": "flash_attention_bwd"}
MAX_ERR = {k: 0.0 for k in (*KERNELS, *OFFSET_KERNELS)}
# The bf16 kernels with a design of their own at one head width (K7 at
# 256, K8 at 96 and 256), in both builds, which must build without
# spills or a serialising ptxas "Performance Loss".
SPILL_FREE_KERNELS = tuple(
    f"{name}{build}>" for name in (
        "flash_fwd_wide_tc<256", "flash_dq_wide_tc<256",
        "flash_dkv_wide_tc<256", "flash_dq_full_tc<96",
        "flash_dkv_full_tc<96")
    for build in ("", ", q_off"))


def agree(key, a, b, what):
    """Require bit equality of a kernel's output with its plain version
    and record the largest absolute difference seen for the kernel."""
    if a is not None and b is not None:
        MAX_ERR[key] = max(MAX_ERR[key], max_abs(a, b))
    require(bits_equal(a, b), what)


# ---------------------------------------------------------------------------
# phase 1: what the compiler made of the flash kernels
# ---------------------------------------------------------------------------

def _kernel_name(mangled):
    """``flash_dkv_tc<64>`` / ``flash_fwd_kernel<float, 64, 64>`` /
    ``flash_delta_kernel<bf16, 96>`` (type, head width, tile rows) from a
    mangled name; the build that takes a query offset (``Sq != Sk`` or
    ``q_off > 0``) ends in ``, q_off>``."""
    import re
    m = re.search(r"(flash_[a-z_]+)I(f|13__nv_bfloat16)?Li(\d+)E(?:Li(\d+)E)?"
                  r"(?:Lb([01])E)?", mangled)
    if not m:
        return mangled
    kind = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2], "")
    return (f"{m[1]}<{kind}{m[3]}"
            f"{f', {m[4]}' if m[4] else ''}"
            f"{', q_off' if m[5] == '1' else ''}>")


def _sass_counts(lib_path):
    """``{kernel: (HGMMA, HMMA)}`` instruction counts in the library's
    SASS, or None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = _kernel_name(line.split("Function : ")[1].strip())
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def _demangle(names):
    """Readable kernel names through the toolkit's ``cu++filt``
    (``encode_kernel<Int8, true>``); the mangled names where it has
    none."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cu++filt")
    if not names or not os.path.exists(tool):
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True, timeout=60).stdout

    def short(line):              # drop namespaces, return type, arguments
        for a, b in (("(anonymous namespace)::", ""), ("<unnamed>::", ""),
                     ("(bool)1", "true"), ("(bool)0", "false")):
            line = line.replace(a, b)
        depth = 0
        for i, c in enumerate(line):
            depth += (c == "<") - (c == ">")
            if c == "(" and depth == 0:
                line = line[:i]
                break
        return line.removeprefix("void ")
    return [short(line) for line in out.splitlines()]


def report_build(source, text):
    """Registers and spills of every kernel of ``source`` from ptxas's
    report; for K7/K8 also the dynamic shared memory of each, then the
    tensor-core instructions in the SASS: each bf16 kernel (``*_tc``)
    must hold HGMMA (wgmma), each f32 kernel none."""
    from repro_torch.kernels import backend
    from repro_torch.kernels import flash_attention as fla
    flash = source == "flash_attention"
    mangled = [line.split("'")[1] for line in text.splitlines()
               if "Compiling entry function" in line]
    names = dict(zip(mangled, [_kernel_name(m) for m in mangled] if flash
                     else _demangle(mangled)))
    smem_kind = {"flash_fwd_tc": 0, "flash_dq_tc": 1, "flash_dkv_tc": 2,
                 "flash_fwd_wide_tc": 0, "flash_dq_wide_tc": 1,
                 "flash_dkv_wide_tc": 2, "flash_dq_full_tc": 1,
                 "flash_dkv_full_tc": 2}
    entry, props, spill = None, None, ""
    spills, losses = {}, set()
    for line in text.splitlines():
        if "Performance Loss" in line:
            what = line.split("Performance Loss:")[1].split(" for the function")[0]
            mangled_name = line.split(chr(39))[-2]
            losses.add(names.get(mangled_name, mangled_name))
            log(f"  ptxas: {names.get(mangled_name, mangled_name)}:{what}")
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "spill" in line and props == entry:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            name = names[entry]
            base = name.split("<")[0]
            smem = ""
            if flash and base in smem_kind:
                head_dim = int(name.split("<")[1].split(",")[0].rstrip(">"))
                smem = (f", dynamic smem "
                        f"{fla._lib().flash_attention_tc_smem(smem_kind[base], head_dim)}"
                        f" B")
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"  {source}: {name:30s} {regs}{smem}; {spill}")
            spills[name] = spill
            entry = None
    if not flash:
        return
    for name in SPILL_FREE_KERNELS:
        require(name in spills, f"ptxas reported nothing for {name}")
        require("0 bytes spill stores, 0 bytes spill loads" in spills[name],
                f"{name} spills: {spills[name]}")
        require(name not in losses, f"ptxas reports a Performance Loss for "
                                    f"{name}")
    log(f"  {', '.join(SPILL_FREE_KERNELS)}: no spills, no Performance "
        f"Loss")
    counts = _sass_counts(backend.library_path("flash_attention"))
    if counts is None:
        log("  cuobjdump not found: SASS not counted")
        return
    for k, (hgmma, hmma) in sorted(counts.items()):
        log(f"  SASS {k:30s} HGMMA {hgmma:3d}  HMMA {hmma:3d}")
        if "_tc<" in k:
            require(hgmma > 0, f"{k} holds no HGMMA: not on the tensor cores")
        else:
            require(hgmma == hmma == 0, f"{k} (f32) holds tensor-core "
                                        f"instructions")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def sample(n, gen, device, outliers=True):
    import torch
    x = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    if outliers:
        x[:: max(n // 97, 1)] *= 300.0
    return x


def check_hop_kernels(gen):
    import torch
    from repro_torch.kernels import fused_hop as fh
    cuda = torch.device("cuda")
    for n in (CHECK_N, RAGGED_N, math.prod(HOP_SHAPE), math.prod(GEMMA_HOP)):
        x = sample(n, gen, cuda)
        agree("hop_absmax", fh.hop_absmax(x), fh.absmax_plain(x),
              f"K1 hop_absmax != plain at n={n}")
        add = sample(n, gen, cuda, outliers=False)
        for name in ("bf16", "int8", "fp8_e4m3"):
            (p, s), (pp, sp) = fh.hop_encode(name, x), fh.encode_plain(name, x)
            agree("hop_encode", p, pp, f"K2 hop_encode[{name}] payload != "
                                       f"plain at n={n}")
            agree("hop_encode", s, sp, f"K2 hop_encode[{name}] scale != "
                                       f"plain at n={n}")
            for a_ in (add, None):
                agree("hop_decode_add", fh.hop_decode_add(name, p, s, a_),
                      fh.decode_add_plain(name, p, s, a_),
                      f"K3 hop_decode_add[{name}, add={a_ is not None}] != "
                      f"plain at n={n}")
        agree("hop_decode_add", fh.hop_decode_add("none", x, None, add),
              fh.decode_add_plain("none", x, None, add),
              f"K3 hop_decode_add[none+add] != plain at n={n}")
        log(f"  K1/K2/K3 bit-exact vs plain at n={n} "
            f"(bf16, int8, fp8_e4m3; scaled x add variants)")
        del x, add, p, s, pp, sp
        torch.cuda.empty_cache()

    # Every path of K2: views 4, 8 and 12 bytes into their storage take
    # the scalar loop (counted in scalar_launches, each view once per
    # codec); small n the ragged tail alone or after one unit.
    buf = sample(CHECK_N, gen, cuda)
    for off in (1, 2, 3):
        x = buf[off:]
        agree("hop_absmax", fh.hop_absmax(x), fh.absmax_plain(x),
              f"K1 hop_absmax != plain on buf[{off}:]")
        for name in ("bf16", "int8", "fp8_e4m3"):
            before = fh.hop_encode.scalar_launches
            (p, s), (pp, sp) = fh.hop_encode(name, x), fh.encode_plain(name, x)
            require(fh.hop_encode.scalar_launches == before + 1,
                    f"K2[{name}] on buf[{off}:] did not take the scalar loop")
            agree("hop_encode", p, pp, f"K2[{name}] payload != plain on "
                                       f"buf[{off}:]")
            agree("hop_encode", s, sp, f"K2[{name}] scale != plain on "
                                       f"buf[{off}:]")
    before = fh.hop_encode.scalar_launches
    for n in SMALL_N:
        x = sample(n, gen, cuda)
        for name in ("bf16", "int8", "fp8_e4m3"):
            (p, s), (pp, sp) = fh.hop_encode(name, x), fh.encode_plain(name, x)
            agree("hop_encode", p, pp, f"K2[{name}] payload != plain at n={n}")
            agree("hop_encode", s, sp, f"K2[{name}] scale != plain at n={n}")
    require(fh.hop_encode.scalar_launches == before,
            "K2 took the scalar loop on an aligned buffer")
    log(f"  K1/K2 bit-exact vs plain on buf[1:], buf[2:], buf[3:] of "
        f"{CHECK_N} (scalar loop, counted) and at n = {SMALL_N} (vector "
        f"path and tail)")

    # bf16 special values on both paths: bit for bit with the card's cast,
    # except that a NaN becomes the kernel's 0x7fc0 whatever NaN the
    # card's cast writes.
    nan, inf = float("nan"), float("inf")
    special = torch.tensor([nan, -nan, inf, -inf, -0.0, 0.0, 3.4e38, -3.4e38,
                            1e-40, -1e-40, 1.00390625, 1.01171875, -2.5],
                           device=cuda).repeat(3)
    for x in (special, special[1:]):
        p, _ = fh.hop_encode("bf16", x)
        pp, _ = fh.encode_plain("bf16", x)
        isnan = torch.isnan(x)
        bits, pbits = p.view(torch.int16), pp.view(torch.int16)
        require(bool((bits[isnan] == 0x7fc0).all()), "K2[bf16] NaN != 0x7fc0")
        require(bool(torch.isnan(pp[isnan].float()).all()),
                "the card's bf16 cast lost a NaN")
        agree("hop_encode", bits[~isnan], pbits[~isnan],
              f"K2[bf16] special values != the card's cast at n={x.numel()}")
    log(f"  K2[bf16] NaN, +-inf, -0, overflow-to-inf, subnormals and ties "
        f"bit-exact with the card's cast on both paths; NaN -> 0x7fc0 (the "
        f"card's cast writes {sorted({hex(v & 0xffff) for v in pbits[isnan].tolist()})})")

    # e4m3 near the top of the range: absmax 448 gives scale 1, so the
    # payload is the cast itself; 432 and 440 round up to exactly 448.
    edge = torch.tensor([448.0, -448.0, 447.9, 440.0, 432.0, -432.0,
                         431.9, 416.0, 0.001953125, -0.0, 1e-3], device=cuda)
    p, s = fh.hop_encode("fp8_e4m3", edge)
    pc, sc = fh.encode_plain("fp8_e4m3", edge.cpu())
    agree("hop_encode", p, pc, "K2 fp8 edge values differ from the CPU cast")
    agree("hop_encode", s, sc, "K2 fp8 edge scale differs from the CPU")
    require(float(p.float()[4]) == 448.0, "432 must round up to 448")
    log("  K2 fp8 edge values (round-up to 448, ties to even) match the "
        "CPU cast")

    # Subnormal regime: the card's kernels against the plain versions on
    # a CPU copy under the flush-to-zero guard (the reference's FTZ).
    cases = {
        "subnormal absmax": torch.full((4096,), 4.4e-39) *
        torch.sign(torch.randn(4096, generator=torch.Generator()
                               .manual_seed(1))),
        "normal absmax, subnormal elements": torch.cat([
            torch.tensor([3.9e-37]), torch.full((4095,), 8e-39)]),
        "tiny-clamped scale": torch.linspace(-1e-36, 1e-36, 4096),
    }
    for label, xc in cases.items():
        xc = xc.to(torch.float32)
        xg = xc.to(cuda)
        agree("hop_absmax", fh.hop_absmax(xg), fh.absmax_plain(xc),
              f"K1 subnormal case {label!r}")
        for name in ("int8", "fp8_e4m3"):
            (p, s), (pc, sc) = fh.hop_encode(name, xg), \
                fh.encode_plain(name, xc)
            agree("hop_encode", p, pc, f"K2[{name}] subnormal {label!r}")
            agree("hop_encode", s, sc, f"K2[{name}] subnormal {label!r}")
            agree("hop_decode_add", fh.hop_decode_add(name, p, s, xg),
                  fh.decode_add_plain(name, pc, sc, xc),
                  f"K3[{name}] subnormal case {label!r}")
        # bf16 keeps subnormals (a cast, no arithmetic); the accumulate
        # flushes them.  The CPU's own f32->bf16 instruction may flush
        # on some hosts, so the decode side is held on one payload.
        p, _ = fh.hop_encode("bf16", xg)
        agree("hop_decode_add", fh.hop_decode_add("bf16", p, None, xg),
              fh.decode_add_plain("bf16", p.cpu(), None, xc),
              f"K3[bf16] subnormal case {label!r}")
    _, s = fh.hop_encode("int8", cases["subnormal absmax"].to(cuda))
    require(float(s) == float(torch.tensor(1.0) / 127.0),
            "subnormal absmax must flush: scale 1/127")
    log("  subnormal regime bit-exact vs plain on the CPU under FTZ "
        "(absmax 4.4e-39 -> scale 1/127)")


def check_adamw(gen):
    import torch
    from repro_torch.kernels import fused_adamw as fa
    cuda = torch.device("cuda")
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              count=3)

    def quartet(n):
        return (sample(n, gen, cuda, outliers=False) * 0.05,
                sample(n, gen, cuda) * 1e-3,
                sample(n, gen, cuda, outliers=False) * 1e-4,
                sample(n, gen, cuda, outliers=False).square() * 1e-6)

    def check(p, g, m, v, what, inplace=False, scalar=False):
        """K5 within 1 ulp of the plain version, on the path expected."""
        ref = fa.adamw_update_plain(p, g, m, v, **kw)
        before = fa.adamw_update.scalar_launches
        out = fa.adamw_update(p, g, m, v, inplace=inplace, **kw)
        require(fa.adamw_update.scalar_launches - before == int(scalar),
                f"K5 {what}: {'not ' if scalar else ''}on the scalar loop")
        ulps = [max_ulp(a, b) for a, b in zip(out, ref)]
        MAX_ERR["adamw_update"] = max(MAX_ERR["adamw_update"],
                                      *(max_abs(a, b)
                                        for a, b in zip(out, ref)))
        require(max(ulps) <= 1, f"K5 adamw_update off by {ulps} ulp {what}")
        return ulps

    for n in (CHECK_N, RAGGED_N, math.prod(LEAF_SHAPE)):
        ulps = check(*quartet(n), f"at n={n}")
        log(f"  K5 adamw_update vs plain at n={n}: max ulp (p, m, v) = "
            f"{ulps}")
    # gemma's tied embedding (3.1 GB a tensor): byte offsets past 2^31.
    n = math.prod(GEMMA_LEAF)
    quad = quartet(n)
    ulps = check(*quad, f"at n={n}")
    ulps += check(*quad, f"in place at n={n}", inplace=True)
    log(f"  K5 adamw_update vs plain at n={n}, out of place then in place: "
        f"max ulp (p, m, v) = {ulps}")
    del quad
    torch.cuda.empty_cache()
    ulps = check(*quartet(RAGGED_N), f"in place at n={RAGGED_N}",
                 inplace=True)
    log(f"  K5 in place (vector path) at n={RAGGED_N}: max ulp {ulps}")
    bufs = quartet(CHECK_N)
    for off in (1, 2, 3):
        ulps = check(*(t[off:] for t in bufs), f"on buf[{off}:]",
                     scalar=True)
        p, _, m, v = quartet(CHECK_N - off)
        ulps += check(p, bufs[1][off:], m, v, f"in place, g = buf[{off}:]",
                      inplace=True, scalar=True)
    log(f"  K5 on buf[1:], buf[2:], buf[3:] of {CHECK_N} and in place with a "
        f"misaligned g: scalar loop, within 1 ulp")
    for n in SMALL_N:
        check(*quartet(n), f"at n={n}")
        check(*quartet(n), f"in place at n={n}", inplace=True)
    log(f"  K5 at n = {SMALL_N}, out of place and in place: vector path "
        f"and tail, within 1 ulp")


def check_fused_reduce(gen):
    """K4 bit for bit against its plain version: both sum rows 0..k-1
    in order in f32, then round to the output type."""
    import torch
    from repro_torch.kernels.fused_reduce import (fused_reduce,
                                                  fused_reduce_plain)
    cuda = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    for (k, n), dtype, out_dtype in (
            ((4, R50_BUCKET), f32, f32), ((4, R50_BUCKET), f32, bf16),
            ((5, RAGGED_N), bf16, bf16), ((5, RAGGED_N), bf16, f32),
            ((5, CHECK_N), bf16, bf16), ((3, RAGGED_N), f32, f32)):
        x = sample(k * n, gen, cuda).reshape(k, n).to(dtype)
        agree("fused_reduce", fused_reduce(x, out_dtype=out_dtype),
              fused_reduce_plain(x, out_dtype),
              f"K4 fused_reduce != plain at ({k}, {n}) {dtype}->{out_dtype}")
        log(f"  K4 fused_reduce bit-exact vs plain at ({k}, {n}) "
            f"{str(dtype)[6:]} -> {str(out_dtype)[6:]}")

    # bf16 [1024, 1, ..., 1]: a running bf16 sum stays at 1024; the f32
    # accumulator gives exactly 1024 + 255 (vector and scalar paths).
    for n in (192, 4099):
        x = torch.cat([torch.full((1, n), 1024.0, dtype=bf16, device=cuda),
                       torch.ones((255, n), dtype=bf16, device=cuda)])
        got = fused_reduce(x, out_dtype=f32)
        require(bool((got == 1279.0).all()), f"K4 [1024, 1...] at n={n}: "
                f"{got.unique().tolist()} != 1279")
        agree("fused_reduce", got, fused_reduce_plain(x, f32),
              f"K4 [1024, 1...] != plain at n={n}")
    # integer-valued rows at ragged n: exact, so equal to the f64 sum.
    for n in (2048 + 37, 3 * 2048 - 1):
        x = (torch.arange(7 * n, dtype=torch.float64, device=cuda)
             .reshape(7, n) % 513.0)
        got = fused_reduce(x.to(f32))
        require(torch.equal(got.double(), x.sum(0)),
                f"K4 integer rows (7, {n}) != the float64 sum")
    log("  K4 exactness pins: [1024, 1 x 255] bf16 -> 1279 exactly; "
        "integer rows (7, 2085) and (7, 6143) equal the float64 sum")

    # Subnormal regime: the card against the plain version on a CPU copy
    # under the flush-to-zero guard.
    tiny = torch.randn((4, 4096), generator=torch.Generator()
                       .manual_seed(2)) * 8e-39
    tiny[0, ::3] = 1.5e-38              # two normals whose sum is subnormal
    tiny[1, ::3] = -1.4e-38
    for xc, out_dtype in ((tiny, f32), (tiny, bf16), (tiny.to(bf16), f32)):
        agree("fused_reduce", fused_reduce(xc.to(cuda), out_dtype=out_dtype),
              fused_reduce_plain(xc, out_dtype),
              f"K4 subnormal case {xc.dtype}->{out_dtype} differs from "
              f"the CPU under FTZ")
    log("  K4 subnormal regime bit-exact vs plain on the CPU under FTZ")


def bf16_ulp(a, b):
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def check_rmsnorm(gen):
    """K6 at phase 4's width (960), phase 6's (3072) and phase 14's
    (xLSTM's 1024, zamba2's 2048 and its shared block's 4096): f32 within
    rtol 1e-5, bf16 within 1 ulp; the share of outputs equal bit for bit
    is printed (the kernel sums a row in another order than torch)."""
    import torch
    from repro_torch.kernels import fused_rmsnorm as frn
    cuda = torch.device("cuda")
    for d in (D_MODEL, GEMMA_D) + RECURRENT_WIDTHS:
        scale = torch.randn(d, generator=gen, device=cuda) * 0.1
        for rows in (LONG_SEQ, 37):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((rows, d), generator=gen,
                                device=cuda).to(dtype)
                y, rstd = frn.fused_rmsnorm(x, scale)
                yp, rp = frn.rmsnorm_plain(x, scale)
                MAX_ERR["fused_rmsnorm"] = max(MAX_ERR["fused_rmsnorm"],
                                               max_abs(y, yp))
                rel = float(((rstd - rp).abs() / rp.abs()).max())
                require(rel <= 1e-5, f"K6 rstd off by {rel:.2e} rel at "
                                     f"({rows}, {d})")
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = float((y.view(bits) == yp.view(bits)).float().mean())
                if dtype == torch.float32:
                    rel = float(((y - yp).abs() / yp.abs().clamp_min(1e-30))
                                .max())
                    require(rel <= 1e-5, f"K6 f32 off by {rel:.2e} rel at "
                                         f"({rows}, {d})")
                    log(f"  K6 fused_rmsnorm f32 ({rows}, {d}): max rel "
                        f"{rel:.2e}, {same:.4%} of outputs bit-equal")
                else:
                    ulp = bf16_ulp(y, yp)
                    require(ulp <= 1, f"K6 bf16 off by {ulp} ulp at "
                                      f"({rows}, {d})")
                    log(f"  K6 fused_rmsnorm bf16 ({rows}, {d}): max "
                        f"{ulp} bf16 ulp, {same:.4%} of outputs bit-equal")
    # Every path: one row, granite's width, a lane's last vector partial
    # (1000), widths no multiple of the vector (1001, 7), and a view one
    # element into its storage; the last three and the view on the scalar
    # path, counted.
    for rows, d, offset in ((1, 3072, 0), (37, 2048, 0), (37, 1000, 0),
                            (37, 1001, 0), (37, 7, 0), (37, 3072, 1),
                            (1, 960, 1)):
        scale = torch.randn(d, generator=gen, device=cuda) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(rows * d + offset, generator=gen,
                               device=cuda).to(dtype)
            x = flat[offset:].view(rows, d)
            scalar = offset != 0 or d % (16 // x.element_size()) != 0
            before = frn.fused_rmsnorm.scalar_launches
            y, rstd = frn.fused_rmsnorm(x, scale)
            require(frn.fused_rmsnorm.scalar_launches == before + scalar,
                    f"K6 ({rows}, {d}) offset {offset} {dtype}: "
                    f"{'not ' if scalar else ''}on the scalar path")
            yp, rp = frn.rmsnorm_plain(x, scale)
            MAX_ERR["fused_rmsnorm"] = max(MAX_ERR["fused_rmsnorm"],
                                           max_abs(y, yp))
            rel = float(((rstd - rp).abs() / rp.abs()).max())
            if dtype == torch.float32:
                rel = max(rel, float(((y - yp).abs() / yp.abs()
                                      .clamp_min(1e-30)).max()))
                require(rel <= 1e-5, f"K6 f32 ({rows}, {d}) offset "
                                     f"{offset} off by {rel:.2e} rel")
            else:
                require(rel <= 1e-5 and bf16_ulp(y, yp) <= 1,
                        f"K6 bf16 ({rows}, {d}) offset {offset} off")
    log("  K6 at one row, widths 2048, 1000, 1001 and 7, and views one "
        "element in: within bounds, on the path expected (scalar for 1001, "
        "7 and the views)")


def _excess(a, b, atol, rtol):
    """max(|a-b| - rtol|b|) / atol: <= 1 is within tolerance."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() - rtol * b.abs()).max()) / atol


def _flash_tol(dtype):
    """K7's and K8's ``(atol, rtol)`` against the plain versions at
    ``dtype``: f32 forward 2e-5 / 1e-4, backward 2e-3; bf16 3e-2
    (tests/test_kernels.py's tolerances)."""
    import torch
    if dtype == torch.float32:
        return (2e-5, 1e-4), (2e-3, 2e-3)
    return (3e-2, 3e-2), (3e-2, 3e-2)


def check_flash(gen):
    """K7/K8 against the chunked plain versions: causal at phase 4's,
    phase 6's and phase 13's (phi-3-vision, head_dim 96) shapes in f32
    and bf16, then window, non-causal and other head widths (16 to 256)
    at ragged S.  f32 forward atol 2e-5 / rtol 1e-4, backward 2e-3; bf16
    3e-2 (tests/test_kernels.py's tolerances).  Every bf16 case is run
    twice and must give the same bits (no atomics)."""
    import torch
    from repro_torch.kernels import flash_attention as fla
    cuda = torch.device("cuda")
    cases = [(ATTN_SHAPE, True, 0, 1024), ((2, 300, 3, 64), True, 100, 64),
             ((2, 300, 3, 64), False, 0, 64), ((1, 200, 2, 16), True, 0, 64),
             ((1, 130, 2, 128), False, 0, 32), ((1, 257, 4, 32), True, 50, 64),
             (GEMMA_ATTN, True, 0, 1024), ((2, 333, 3, 256), True, 100, 64),
             ((2, 333, 3, 256), False, 0, 64), ((1, 64, 3, 256), True, 0, 64),
             ((2, 513, 3, 256), False, 0, 64),
             (GEMMA_ATTN, True, 1024, 1024),
             (PHI3_ATTN, True, 0, 1024), ((2, 333, 3, 96), True, 100, 64),
             ((2, 300, 3, 96), False, 0, 64), ((1, 257, 4, 96), True, 0, 64),
             (PHI3_ATTN, True, 1024, 1024)]
    for shape, causal, window, chunk in cases:
        for dtype in (torch.float32, torch.bfloat16):
            tol_f, tol_b = _flash_tol(dtype)
            q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                           .to(dtype) for _ in range(4))
            kw = dict(causal=causal, window=window, chunk=chunk)
            out, lse = fla.flash_attention_fwd(q, k, v, **kw)
            grads = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            pout, plse = fla.flash_fwd_plain(q, k, v, **kw)
            pgrads = fla.flash_bwd_plain(q, k, v, pout, plse, do, **kw)
            ex_f = max(_excess(out, pout, *tol_f), _excess(lse, plse, *tol_f))
            ex_b = max(_excess(g, p, *tol_b) for g, p in zip(grads, pgrads))
            MAX_ERR["flash_attention_fwd"] = max(
                MAX_ERR["flash_attention_fwd"], max_abs(out, pout),
                max_abs(lse, plse))
            MAX_ERR["flash_attention_bwd"] = max(
                MAX_ERR["flash_attention_bwd"],
                *(max_abs(g, p) for g, p in zip(grads, pgrads)))
            what = (f"{tuple(shape)} {str(dtype)[6:]} causal={causal} "
                    f"window={window}")
            log(f"  K7/K8 {what}: max err/tol fwd {ex_f:.3f} bwd {ex_b:.3f}")
            require(ex_f <= 1.0, f"K7 flash_attention_fwd != plain at {what}")
            require(ex_b <= 1.0, f"K8 flash_attention_bwd != plain at {what}")
            if dtype == torch.bfloat16:
                again = (*fla.flash_attention_fwd(q, k, v, **kw),
                         *fla.flash_attention_bwd(q, k, v, out, lse, do, **kw))
                require(all(bits_equal(a, b) for a, b in
                            zip(again, (out, lse, *grads))),
                        f"K7/K8 bf16 not deterministic at {what}")
                del again
            del q, k, v, do, out, lse, grads, pout, plse, pgrads
    torch.cuda.empty_cache()


def check_delta(gen):
    """K8's ``rowsum(dO∘O)`` kernel against ``_delta`` per row within
    dh·2⁻²⁴·Σ|dO∘O| (the f32 summation bound; the two sum in different
    orders) at every head width in f32 and bf16, S 333 and 4096, and on
    f32 views one element off a 16-byte boundary (element loads); two
    calls give the same bits."""
    import torch
    from repro_torch.kernels import flash_attention as fla
    cuda = torch.device("cuda")
    worst = 0.0
    for dh in fla.HEAD_DIMS:
        for s_, dtype in itertools.product((333, LONG_SEQ),
                                           (torch.float32, torch.bfloat16)):
            shape = (2, s_, 3, dh) if s_ == 333 else (1, s_, 16, dh)
            views = [torch.randn(shape, generator=gen, device=cuda)
                     .to(dtype) for _ in range(2)]
            if dtype == torch.float32 and s_ == 333:
                n = math.prod(shape)
                flat = torch.randn(2 * n + 2, generator=gen, device=cuda)
                views += [flat[1:n + 1].view(shape), flat[n + 2:].view(shape)]
            for out, do in zip(views[::2], views[1::2]):
                got = fla._delta_launch(out, do)
                want = fla._delta(out, do)
                tol = fla.delta_tolerance(out, do)
                excess = float(((got - want).abs() - tol).max())
                worst = max(worst, float(((got - want).abs()
                                          / tol.clamp_min(1e-30)).max()))
                MAX_ERR["flash_attention_bwd"] = max(
                    MAX_ERR["flash_attention_bwd"], max_abs(got, want))
                what = (f"{shape} {str(dtype)[6:]}"
                        f"{'' if out.data_ptr() % 16 == 0 else ' (off 16 B)'}")
                require(excess <= 0.0, f"K8's delta kernel != _delta at "
                                       f"{what}: {excess} past the bound")
                require(bits_equal(got, fla._delta_launch(out, do)),
                        f"K8's delta kernel not deterministic at {what}")
    log(f"  K8's delta kernel within dh 2^-24 sum|dO*O| of _delta per row "
        f"at head widths {fla.HEAD_DIMS}, f32 and bf16, S 333 and "
        f"{LONG_SEQ}, aligned and not (largest |diff| / bound {worst:.4f})")


def measure(gen):
    """Per-kernel times at the main path's largest shapes (phase 6's hop
    and leaf as ``variants`` of K1–K3 and K5).  Each row:
    the kernel's ms, its bound and what bounds it, the plain version's
    ms and, where one PyTorch call computes the same function, its ms
    (timed in turns with the kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_adamw as fa, fused_hop as fh
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import fused_rmsnorm as frn
    from repro_torch.kernels.fused_reduce import (fused_reduce,
                                                  fused_reduce_plain)
    cuda = torch.device("cuda")
    rows = {}

    def turns(fn, *lists):
        """``fn`` on the i-th entry of each list, i = 0, 1, 2, 0, ...
        from one call to the next."""
        order = itertools.cycle(range(3))

        def call():
            i = next(order)
            return fn(*(lst[i] for lst in lists))
        return call

    def row(key, fn, plain, library, n_bytes, n_flops, what,
            tensor_cores=False):
        # The kernel and its yardstick in turns (kernel, library, library,
        # kernel), TURN_REPS calls each; the mean of each pair.
        runs = {fn: [], library: []}
        for f in (fn, library, library, fn) if library else (fn, fn):
            runs[f].append(time_ms(f, reps=TURN_REPS))
        ms = sum(runs[fn]) / 2
        b_ms, by = bound_ms(n_bytes, n_flops, tensor_cores)
        rec = {"ms": ms, "plain_ms": time_ms(plain) if plain else None,
               "library_ms": sum(runs[library]) / 2 if library else None,
               "bound_ms": b_ms, "bound_by": by}
        log(f"  {key:24s} {what}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{by}, plain {rec['plain_ms']}, library {rec['library_ms']}; "
            f"turns {runs[fn]}{f' / {runs[library]}' if library else ''})")
        return rec

    def hop_rows(shape, codecs):
        """K1, K2 (each of ``codecs``) and K3 (int8) at one hop shape."""
        n = math.prod(shape)
        # x (and the rest) in turn from three buffers of the hop shape,
        # each larger than the 50 MB L2: no call finds the previous
        # call's data there, and only the reuse between K1 and K2 inside
        # one hop_encode remains.
        xs = [sample(n, gen, cuda).reshape(shape) for _ in range(3)]
        adds = [sample(n, gen, cuda, outliers=False).reshape(shape)
                for _ in range(3)]
        encoded = [fh.hop_encode("int8", x) for x in xs]
        payloads = [e[0] for e in encoded]
        scales = [e[1] for e in encoded]
        scale_fs = [float(s_) for s_ in scales]
        bits = [fh._absmax_launch(x) for x in xs]
        out = {"hop_absmax": row(
            "hop_absmax", turns(fh.hop_absmax, xs),
            turns(fh.absmax_plain, xs),
            turns(lambda x: x.abs().amax(), xs), 4 * n, 2 * n,
            f"f32 {shape}")}
        # K2: bf16 is a cast (one PyTorch call computes it); int8 and fp8
        # clip at +-127 / +-448 with a scale from the absmax, which no
        # single PyTorch call computes.  Their quantize pass alone (K2 on
        # bits K1 computed earlier, x cold in L2) has its own bound.
        variants = {}
        for name in codecs:
            out_bytes = 2 if name == "bf16" else 1
            variants[name] = row(
                f"hop_encode[{name}]",
                turns(lambda x, name=name: fh.hop_encode(name, x), xs),
                turns(lambda x, name=name: fh.encode_plain(name, x), xs),
                turns(lambda x: x.to(torch.bfloat16), xs) if name == "bf16"
                else None,
                4 * n + out_bytes * n + (0 if name == "bf16" else 4),
                (0 if name == "bf16" else 6) * n,
                f"{name} {shape}" + ("" if name == "bf16"
                                     else " (absmax + quantize)"))
            if name != "bf16":
                variants[f"{name} pass"] = row(
                    f"hop_encode[{name}] pass",
                    turns(lambda x, b, name=name:
                          fh._encode_launch(name, x, b), xs, bits),
                    None, None, 5 * n + 8, 4 * n,
                    f"{name} {shape} quantize pass alone")
        out["hop_encode"] = variants
        out["hop_decode_add"] = row(
            "hop_decode_add",
            turns(lambda q, s_, a: fh.hop_decode_add("int8", q, s_, a),
                  payloads, scales, adds),
            turns(lambda q, s_, a: fh.decode_add_plain("int8", q, s_, a),
                  payloads, scales, adds),
            turns(lambda q, s_, a: torch.add(a, q, alpha=s_), payloads,
                  scale_fs, adds), n + 4 * n + 4 * n, 2 * n,
            f"int8*scale+add {shape}")
        return out

    # The rows' own numbers are phase 3's hop; phase 6's first hop of the
    # tied embedding (int8, its codec) is a variant of each.
    smol = hop_rows(HOP_SHAPE, ("bf16", "int8", "fp8_e4m3"))
    torch.cuda.empty_cache()
    big = hop_rows(GEMMA_HOP, ("int8",))
    torch.cuda.empty_cache()
    for k in ("hop_absmax", "hop_decode_add"):
        rows[k] = {**smol[k], "variants": {"smollm hop": smol[k],
                                           "gemma hop": big[k]}}
    rows["hop_encode"] = {**smol["hop_encode"]["int8"], "variants": {
        **smol["hop_encode"],
        **{f"{v} gemma hop": r for v, r in big["hop_encode"].items()}}}
    del smol, big
    k4 = sample(CNN_WORLD * R50_BUCKET, gen, cuda).reshape(CNN_WORLD,
                                                           R50_BUCKET)
    rows["fused_reduce"] = row(
        "fused_reduce", lambda: fused_reduce(k4),
        lambda: fused_reduce_plain(k4),
        lambda: torch.sum(k4, 0, dtype=torch.float32),
        4 * CNN_WORLD * R50_BUCKET + 4 * R50_BUCKET,
        (CNN_WORLD - 1) * R50_BUCKET, f"f32 {tuple(k4.shape)}")
    del k4

    def adamw_row(shape):
        nl = math.prod(shape)
        p = sample(nl, gen, cuda, outliers=False) * 0.05
        g = sample(nl, gen, cuda) * 1e-3
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                  count=1)
        library = None
        if hasattr(torch, "_fused_adamw_"):
            step = [torch.ones((), device=cuda)]

            def library():
                torch._fused_adamw_([p], [g], [m], [v], [], step, lr=1e-3,
                                    beta1=0.9, beta2=0.95, weight_decay=0.1,
                                    eps=1e-8, amsgrad=False, maximize=False)
        return row(
            "adamw_update",
            lambda: fa.adamw_update(p, g, m, v, inplace=True, **kw),
            lambda: fa.adamw_update_plain(p, g, m, v, **kw), library,
            16 * nl + 12 * nl, 15 * nl, f"f32 in place {shape}")

    smol = adamw_row(LEAF_SHAPE)
    torch.cuda.empty_cache()
    big = adamw_row(GEMMA_LEAF)
    torch.cuda.empty_cache()
    rows["adamw_update"] = {**smol, "variants": {"smollm leaf": smol,
                                                 "gemma leaf": big}}

    # K6 at phase 4's and phase 6's activations, and at zamba2's shared
    # block (phase 14; its norm over concat(hidden, embedding)): (B*S, d)
    # bf16.
    norm_rows = {}
    for d in (D_MODEL, GEMMA_D, ZAMBA2_NORM_D):
        xr = torch.randn((LONG_SEQ, d), generator=gen,
                         device=cuda).to(torch.bfloat16)
        sc = torch.randn(d, generator=gen, device=cuda) * 0.1
        w = (1.0 + sc).to(torch.bfloat16)
        norm_rows[f"bf16 d{d}"] = row(
            "fused_rmsnorm", lambda: frn.fused_rmsnorm(xr, sc),
            lambda: frn.rmsnorm_plain(xr, sc),
            lambda: F.rms_norm(xr, (d,), w, 1e-6),
            LONG_SEQ * d * 4 + 4 * d + 4 * LONG_SEQ,
            4 * LONG_SEQ * d, f"bf16 ({LONG_SEQ}, {d})")
    rows["fused_rmsnorm"] = {**norm_rows[f"bf16 d{D_MODEL}"],
                             "variants": norm_rows}
    del xr, sc, w

    # K7/K8 at one layer of phase 4, (1, 4096, 15, 64), of phase 6,
    # (1, 4096, 16, 256), and of phase 13's phi-3-vision, (1, 4096, 32,
    # 96), causal: bf16 on the tensor cores (the main path) and f32 on
    # the CUDA cores.  The rows' own numbers are phase 4's bf16; every
    # case is a variant ("bf16" and "f32" at dh 64, "bf16 dh256", "f32
    # dh256", "bf16 dh96" and "f32 dh96").
    fwd_rows, bwd_rows = {}, {}
    for shape, tag in ((ATTN_SHAPE, ""), (GEMMA_ATTN, " dh256"),
                       (PHI3_ATTN, " dh96")):
        b, s_, h, dh = shape
        elems = b * s_ * h * dh
        causal_pairs = b * h * s_ * s_ / 2
        q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                       .to(torch.bfloat16) for _ in range(4))
        for name, dtype, size in (("bf16", torch.bfloat16, 2),
                                  ("f32", torch.float32, 4)):
            q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
            out, lse = fla.flash_attention_fwd(q, k, v)
            qt, kt, vt = (t.transpose(1, 2).contiguous()
                          .requires_grad_(True) for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
            unit = "tensor cores" if name == "bf16" else "CUDA cores"
            fwd_rows[name + tag] = row(
                f"flash_attention_fwd[{name}]",
                lambda: fla.flash_attention_fwd(q, k, v),
                lambda: fla.flash_fwd_plain(q, k, v, chunk=1024),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                4 * elems * size + 4 * b * h * s_, 4 * causal_pairs * dh,
                f"causal {shape}, {unit}", tensor_cores=name == "bf16")
            bwd_rows[name + tag] = row(
                f"flash_attention_bwd[{name}]",
                lambda: fla.flash_attention_bwd(q, k, v, out, lse, do),
                lambda: fla.flash_bwd_plain(q, k, v, out, lse, do,
                                            chunk=1024),
                lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                            retain_graph=True),
                8 * elems * size + 4 * b * h * s_, 8 * causal_pairs * dh,
                f"causal {shape} (delta + dq pass + dk/dv pass), {unit}",
                tensor_cores=name == "bf16")
            if name == "bf16":
                # The parts alone: rowsum(dO*O) (the kernel, against
                # _delta, its plain version and the one PyTorch call for
                # it), then at dh 96 and 256 each pass of the kernel
                # (three products, then four).
                delta = fla._delta_launch(out, do)
                io = 5 * elems * size + 8 * b * h * s_
                parts = [("delta", lambda: fla._delta_launch(out, do),
                          lambda: fla._delta(out, do),
                          2 * elems * size + 4 * b * h * s_, 2 * elems,
                          False)]
                if dh != 64:
                    parts += [
                        ("dq pass", lambda: fla._bwd_launch(
                            q, k, v, do, lse, delta, True, 0, passes=1),
                         None, io, 6 * causal_pairs * dh, True),
                        ("dk/dv pass", lambda: fla._bwd_launch(
                            q, k, v, do, lse, delta, True, 0, passes=2),
                         None, io + elems * size, 8 * causal_pairs * dh,
                         True)]
                for part, fn, plain, n_bytes, n_flops, tc in parts:
                    bwd_rows[f"bf16{tag or ' dh64'} {part}"] = row(
                        f"flash_attention_bwd[{part}]", fn, plain, plain,
                        n_bytes, n_flops, f"causal {shape} {part} alone",
                        tensor_cores=tc)
                del delta
        del q, k, v, do, out, lse, qt, kt, vt, dot, lib_out
        torch.cuda.empty_cache()
    rows["flash_attention_fwd"] = {**fwd_rows["bf16"], "variants": fwd_rows}
    rows["flash_attention_bwd"] = {**bwd_rows["bf16"], "variants": bwd_rows}
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path on 4 ranks
# ---------------------------------------------------------------------------

def train_args(**over):
    from repro_torch.launch.train import parser
    base = ["--arch", "smollm-360m", "--steps", str(TRAIN_STEPS),
            "--strategy", "rhd_rsa", "--codec", "int8", "--lr", "1e-3",
            "--log-every", "1"]
    args = parser().parse_args(base)
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _wrappers():
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import fused_adamw as fa, fused_hop as fh
    from repro_torch.kernels import fused_rmsnorm as frn
    from repro_torch.kernels.fused_reduce import fused_reduce
    return {"hop_absmax": fh.hop_absmax, "hop_encode": fh.hop_encode,
            "hop_decode_add": fh.hop_decode_add,
            "fused_reduce": fused_reduce,
            "adamw_update": fa.adamw_update,
            "fused_rmsnorm": frn.fused_rmsnorm,
            "flash_attention_fwd": fla.flash_attention_fwd,
            "flash_attention_bwd": fla.flash_attention_bwd}


SCALAR = ("hop_encode", "adamw_update", "fused_rmsnorm")   # with a scalar loop


def _counts():
    wrappers = _wrappers()
    out = {k: fn.launches for k, fn in wrappers.items()}
    out.update({k: wrappers[base].offset_launches
                for k, base in OFFSET_KERNELS.items()})
    return out


def _scalar_counts():
    return {k: _wrappers()[k].scalar_launches for k in SCALAR}


def _reset_counts():
    for k, fn in _wrappers().items():
        fn.launches = 0
        if hasattr(fn, "offset_launches"):
            fn.offset_launches = 0
        if k in SCALAR:
            fn.scalar_launches = 0


def _cache_counts():
    from repro_torch.core import plan_cache
    return (plan_cache.GLOBAL_PLAN_CACHE.stats(),
            plan_cache.GLOBAL_EXECUTOR_CACHE.stats())


def _cache_delta(before):
    """A step's plan-cache hits and misses, and the executors' builds
    against the executors held, after the step."""
    plans, executors = _cache_counts()
    return {"plan_hits": plans["hits"] - before[0]["hits"],
            "plan_misses": plans["misses"] - before[0]["misses"],
            "executors": executors["interned"],
            "executor_traces": executors["traces"]}


def _require_cached(rank, label, steps):
    """Executors built once each, by the end of step 1, and none built
    or added after it; from step 2 on the plan cache only hits."""
    first = steps[0]
    built = (first["executors"], first["executor_traces"])
    require(built[1] == built[0] >= 1,
            f"rank {rank} {label} step 1: {built[0]} executors built "
            f"{built[1]} times")
    for s_, rec in enumerate(steps[1:], 2):
        require((rec["executors"], rec["executor_traces"]) == built,
                f"rank {rank} {label} step {s_}: {rec['executors']} "
                f"executors built {rec['executor_traces']} times, after "
                f"{built[0]} built {built[1]} times by step 1")
        require(rec["plan_misses"] == 0 and rec["plan_hits"] >= 1,
                f"rank {rank} {label} step {s_}: plan cache "
                f"{rec['plan_hits']} hits, {rec['plan_misses']} misses")


def _checksum(params):
    import torch
    from repro_torch import tree
    total = 0
    for p in tree.leaves(params):
        total += int(p.detach().view(torch.int32).to(torch.int64).sum())
    return total


def _step_breakdown(trainer, module, device, step, rank, world,
                    profile=False):
    """Host-clock seconds of the step's layers, each timed alone after
    the main path (synchronised before and after): forward+backward on
    this rank's shard (one rank at a time, so the card is not shared),
    the aggregation of the full gradient tree (all ranks, it is a
    collective), and the optimizer update; the bytes the transport moved
    in that aggregate, and with ``profile`` one more aggregate's
    profiled split."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.core import dist as core_dist
    from repro_torch.models import param_groups
    from repro_torch.train.step import shard_batch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    params = module.tree()
    agg = trainer.extras["aggregator"]
    batch = {k: v.to(device) for k, v in shard_batch(
        trainer.data_iter_fn(step),
        [agg.groups[ax] for ax in agg.dp_axes]).items()}
    # On a model axis the gather boundary is a collective: every rank
    # gathers first, then runs its forward+backward alone.
    gather = trainer.extras.get("gather")
    before = dict(core_dist.traffic)
    t_gather, full = timed(lambda: params if gather is None
                           else gather(params))
    gathered = {k: core_dist.traffic[k] - before[k] for k in before}

    def fwd_bwd():
        loss, _ = trainer.model.loss(full, batch)
        loss.backward()
        return tree.tree_map(lambda p: p.grad, params)

    for r in range(world):
        if world > 1:
            dist.barrier()
        if r == rank:
            t_fb, grads = timed(fwd_bwd)
    if world > 1:
        dist.barrier()
    before = dict(core_dist.traffic)
    t_agg, reduced = timed(lambda: agg(grads, groups=param_groups(params)))
    traffic = {k: core_dist.traffic[k] - before[k] for k in before}
    split = _aggregate_split(lambda: agg(
        grads, groups=param_groups(params))) if profile else None
    state = trainer.optimizer.init(params)
    t_opt, _ = timed(lambda: trainer.optimizer.update(reduced, state,
                                                      params))
    for p in tree.leaves(params):
        p.grad = None
    return {"fwd_bwd_s": t_fb, "aggregate_s": t_agg, "optimizer_s": t_opt,
            "traffic": traffic, "split": split, "gather_s": t_gather,
            "gather_traffic": gathered}


# The aggregate's parts: device time of copies by direction and of the
# hop (K1-K3) and reduce (K4) kernels, host time in the transport's
# profiler spans (core/dist.py).
HOP_KERNELS = ("absmax_kernel", "encode_kernel", "decode_add_kernel")
REDUCE_KERNELS = ("reduce_vec", "reduce_scalar")
WAIT_SPANS = {"gloo waits": ("gloo.ppermute", "gloo.all_gather",
                             "gloo.psum"),
              "channel waits": ("cuda_ipc.notify_wait",
                                "cuda_ipc.ack_wait", "cuda_ipc.sync")}


def _aggregate_split(run):
    """Run one aggregate under ``torch.profiler`` and split its time:
    ms of host<->device and device<->device copies, K1-K3 and K4 on the
    card, ms the host spent in gloo's waits and in cuda_ipc's (on the
    card only the channel's sync at the aggregate's end: no hop waits),
    the number of host<->device copies, and the bytes the transport
    staged through the host or wrote through mappings."""
    import torch
    from repro_torch.core import dist
    act = torch.profiler.ProfilerActivity
    before = dict(dist.traffic)
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        run()
        sync()
    ms = {"host<->device copies": 0.0, "device<->device copies": 0.0,
          "K1-K3": 0.0, "K4": 0.0, "gloo waits": 0.0, "channel waits": 0.0}
    n_host = 0
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        dev = (e.cuda_time_total if dev is None else dev) / 1e3
        name = e.key
        if name.startswith("Memcpy"):
            if "HtoD" in name or "DtoH" in name:
                ms["host<->device copies"] += dev
                n_host += e.count
            elif "DtoD" in name or "PtoP" in name:
                ms["device<->device copies"] += dev
        elif any(k in name for k in HOP_KERNELS):
            ms["K1-K3"] += dev
        elif any(k in name for k in REDUCE_KERNELS):
            ms["K4"] += dev
        for label, spans in WAIT_SPANS.items():
            if name in spans:
                ms[label] += e.cpu_time_total / 1e3
    return {"wall_ms": (time.perf_counter() - t0) * 1e3, "ms": ms,
            "host_device_copies": n_host,
            **{k: dist.traffic[k] - before[k] for k in before}}


def _split_line(split):
    return (f"profiled aggregate {split['wall_ms']:.1f} ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in split["ms"].items())
            + f" (ms); {split['host_device_copies']} host<->device copies, "
              f"{split['staged_bytes']} B staged through the host, "
              f"{split['mapped_bytes']} B written through mappings, "
              f"{split['control_messages']} control messages, "
              f"{split['device_waits']} waits on the card")


def _card_in_use_gib(world):
    """GiB the whole card holds now, read by each rank while every rank
    still holds its state: each process's context, its allocator's
    reserved blocks (workspaces included) and the parent's, plus the
    blocks this rank's allocator held at its peak and has given back
    since (none unless an allocation was retried).  Returns the card's
    figure and this rank's given-back blocks, apart."""
    import torch
    import torch.distributed as dist
    torch.cuda.synchronize()
    if world > 1:
        dist.barrier()
    free, total = torch.cuda.mem_get_info()
    released = torch.cuda.max_memory_reserved() - torch.cuda.memory_reserved()
    if world > 1:
        dist.barrier()
    return (total - free) / 2 ** 30, released / 2 ** 30


def train_rank(rank, world, args, small_args, spec=None, small_spec=None,
               profile=False):
    import torch
    from repro_torch import tree
    from repro_torch.core import Group
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.common import ParamTree

    if args.device == "cuda":
        torch.cuda.set_device(0)
    group = Group()
    trainer = build_trainer(args, verbose=False, spec=spec,
                            groups={"data": group})
    module, opt_state = trainer.init_state(args.seed)
    n_params = sum(p.numel() for p in module.parameters())
    steps = []
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()                           # main path starts here
    for s in range(args.steps):
        before, cache0 = _counts(), _cache_counts()
        module, opt_state, hist = trainer.run(1, module, opt_state,
                                              start_step=s)
        after = _counts()
        steps.append({**hist[0], "launches": {k: after[k] - before[k]
                                              for k in after},
                      **_cache_delta(cache0),
                      "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30
                      if args.device == "cuda" else 0.0})
    totals = _counts()                        # main path ends here
    scalar = _scalar_counts()
    plan = _plan_hop_launches(trainer.extras["aggregator"].last_schedule)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if args.device == "cuda" else 0.0
    reserved_gib = torch.cuda.max_memory_reserved() / 2 ** 30 \
        if args.device == "cuda" else 0.0
    card_gib, released_gib = _card_in_use_gib(world) \
        if args.device == "cuda" else (0.0, 0.0)
    checksum = _checksum(module.tree())
    del opt_state             # the breakdown makes its own optimizer state
    breakdown = _step_breakdown(trainer, module, args.device, args.steps,
                                rank, world, profile)
    del module, trainer

    # Small reference check: the same step on the card and on the host's
    # plain versions, from one initialisation, must agree.
    losses, finals = {}, {}
    init = None
    for device in ("cpu", args.device):
        small = build_trainer(argparse.Namespace(**{**vars(small_args),
                                                    "device": device}),
                              groups={"data": group}, verbose=False,
                              spec=small_spec)
        if init is None:
            init = small.init_state(small_args.seed)[0].tree()
        mod = ParamTree(tree.tree_map(
            lambda t: t.detach().clone().to(device), init))
        mod, _, hist = small.run(small_args.steps, mod,
                                 small.optimizer.init(mod.tree()))
        losses[device] = [h["loss"] for h in hist]
        finals[device] = tree.leaves(mod.tree())
    param_diff = max(float((a.detach().cpu() - b.detach().cpu()).abs().max())
                     for a, b in zip(finals["cpu"], finals[args.device]))
    return {"rank": rank, "n_params": n_params, "steps": steps,
            "breakdown": breakdown,
            "totals": totals, "scalar": scalar, "checksum": checksum,
            "plan_launches": plan, "peak_gib": peak_gib, "reserved_gib": reserved_gib,
            "card_gib": card_gib, "released_gib": released_gib,
            "small_losses": losses, "small_param_diff": param_diff}


TRANSPORT_NOTE = {
    "gloo": "CUDA payloads staged through host memory explicitly",
    "cuda_ipc": "payloads copied device to device into receive slots the "
                "peers mapped once, each hop's notify and acknowledgement "
                "a counter the card waits on"}


def _traffic_line(bd):
    t = bd["traffic"]
    return (f"aggregate moved {t['staged_bytes']} B staged through the "
            f"host, {t['mapped_bytes']} B written through mappings, "
            f"{t['control_messages']} control messages, "
            f"{t['device_waits']} waits on the card")


def _require_on_card(bd, what):
    """On cuda_ipc the timed aggregate stages no byte through the host
    and writes through the mappings; a profiled one shows no copy
    between host and card."""
    t, split = bd["traffic"], bd["split"]
    require(t["staged_bytes"] == 0 and t["mapped_bytes"] > 0,
            f"{what}: the cuda_ipc aggregate staged through the host: {t}")
    if split is not None:
        require(split["host_device_copies"] == 0
                and split["staged_bytes"] == 0,
                f"{what}: the profiled cuda_ipc aggregate copied between "
                f"host and card: {split}")


def run_phase(world, args, small, required, spec=None, small_spec=None,
              backend="gloo", profile=False):
    """Train ``args`` (or ``spec``, when given) on ``world`` ranks sharing
    the card over ``backend``, print each step, and require finite
    losses, one parameter checksum on every rank, launches of every
    ``required`` kernel, executors built once and plan-cache hits only
    from step 2, on cuda_ipc an aggregate with no host copy, and the
    small model's (``small``, or ``small_spec``) card-vs-host agreement.
    With ``profile`` every rank profiles one aggregate.  Returns each
    rank's record."""
    from repro_torch.core.dist import run_ranks
    log(f"  transport: {backend}, {world} ranks on one card, "
        f"{TRANSPORT_NOTE[backend]}; batch {args.batch // world} per rank, "
        f"seq {args.seq}, {args.steps} steps")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(train_rank, world,
                            (args, small, spec, small_spec, profile),
                            backend=backend, rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1) // world),
                            timeout_s=900)
    log(f"  {world} ranks done in {time.perf_counter() - t0:.1f} s; "
        f"{results[0]['n_params']} parameters per replica; GiB per rank "
        f"allocated at peak {[round(r['peak_gib'], 2) for r in results]}, "
        f"reserved at peak {[round(r['reserved_gib'], 2) for r in results]}"
        f"; the card in use at the main path's end "
        f"{max(r['card_gib'] for r in results):.2f} GiB")
    for s, rec in enumerate(results[0]["steps"]):
        log(f"  step {s + 1}: loss {rec['loss']:.5f} grad_norm "
            f"{rec['grad_norm']:.5f} step_s {rec['step_s']:.3f} buckets "
            f"{rec['n_buckets']} GiB reserved {rec['reserved_gib']:.2f} "
            f"launches/rank {rec['launches']}")
    for r in results:
        bd = r["breakdown"]
        log(f"  rank {r['rank']} layers, one step timed alone after the "
            f"main path: " + ", ".join(f"{k} {bd[k]:.3f}" for k in
                                      ("fwd_bwd_s", "aggregate_s",
                                       "optimizer_s")))
        log(f"    {_traffic_line(bd)}")
        if bd["split"] is not None:
            log(f"    {_split_line(bd['split'])}")
        _require_cached(r["rank"], backend, r["steps"])
        if backend == "cuda_ipc":
            _require_on_card(bd, f"rank {r['rank']}")
    log(f"  executors built once each by step 1 "
        f"({results[0]['steps'][0]['executors']} per rank); plan cache "
        f"hits {[rec['plan_hits'] for rec in results[0]['steps']]} and "
        f"misses {[rec['plan_misses'] for rec in results[0]['steps']]} "
        f"per step")
    log(f"  scalar-loop launches per rank (K2 hop_encode, K5 adamw_update, "
        f"K6 fused_rmsnorm) "
        f"over the {args.steps} steps: {[r['scalar'] for r in results]}, of "
        f"{[{k: r['totals'][k] for k in SCALAR} for r in results]} launches")
    for r in results:
        require(all(r["totals"][k] > 0 for k in required),
                f"rank {r['rank']}: a kernel never launched {r['totals']}")
        require(all(math.isfinite(rec["loss"]) for rec in r["steps"]),
                f"rank {r['rank']}: non-finite loss")
        want = r["plan_launches"]
        for s_, rec in enumerate(r["steps"], 1):
            got = {k: rec["launches"][k] for k in want}
            require(got == want, f"rank {r['rank']} step {s_}: K1-K3 "
                                 f"launched {got}, the plan's hops imply "
                                 f"{want}")
    log(f"  K1-K3 per rank per step {results[0]['plan_launches']}, as the "
        f"plan's hops imply (a joined RHD block encoded at its own scale)")
    sums = {r["checksum"] for r in results}
    require(len(sums) == 1, f"parameters differ across ranks: {sums}")
    log(f"  parameters bit-identical on all {world} ranks "
        f"(checksum {sums.pop()})")
    sl = results[0]["small_losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(sl["cpu"], sl[args.device]))
    log(f"  small float32 model at seq {small.seq}, card vs host plain "
        f"versions: losses {sl[args.device]} vs {sl['cpu']} (max rel "
        f"{rel:.2e}), max param diff {results[0]['small_param_diff']:.2e}")
    require(rel <= 1e-3, "card and host training disagree")
    return results


# ---------------------------------------------------------------------------
# phase 5: the paper's CNNs under each aggregation strategy
# ---------------------------------------------------------------------------

def cnn_trainer(name, strategy, image, batch, dtype, device, group,
                data_device=None, overlap=False, groups=None):
    """The CNN step of the tf_cnn_benchmarks analogue: ``make_train_step``
    with SGD ``p - 0.05 g`` (no momentum) and a clip that never clips;
    ``ps_gather`` fuses its terminal sum (K4); ``overlap`` reduces the
    buckets inside the backward.  ``groups`` (the dp groups by axis, in
    place of ``group`` as the one data axis) runs it on a mesh."""
    from repro_torch.core import AggregatorConfig
    from repro_torch.data import SyntheticImages
    from repro_torch.models import CnnSpec, build_cnn
    from repro_torch.optim import sgd
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
    agg = AggregatorConfig(strategy=strategy,
                           fused_hops=True if strategy == "ps_gather"
                           else None, overlap=overlap)
    groups = groups or {"data": group}
    cfg = TrainerConfig(steps=CNN_WARMUP + CNN_TIMED, step=TrainStepConfig(
        aggregator=agg, clip_norm=1e30, dp_axes=tuple(groups)))
    data = SyntheticImages(batch, image_size=image, device=data_device)
    return Trainer(build_cnn(CnnSpec(name, image_size=image, dtype=dtype)),
                   sgd(0.05, momentum=0.0), data.batch_at, cfg,
                   device=device, verbose=False, groups=groups)


def cnn_rank(rank, world, cnn_runs, transports, deterministic,
             overlap=False):
    import torch
    from repro_torch import tree
    from repro_torch.core import Group, plan_cache
    from repro_torch.models.common import ParamTree

    torch.cuda.set_device(0)
    # float32 convolutions in full precision for the card-vs-host check.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    groups = {t: Group(transport=t) for t in transports}
    runs = []
    for name, strategies in cnn_runs:
        for strategy, transport in itertools.product(strategies,
                                                     transports):
            trainer = cnn_trainer(name, strategy, CNN_IMAGE, CNN_BATCH,
                                  "bfloat16", "cuda", groups[transport],
                                  data_device="cuda", overlap=overlap)
            module, opt_state = trainer.init_state(0)
            torch.cuda.reset_peak_memory_stats()
            steps = []
            _reset_counts()                   # main path starts here
            for s in range(CNN_WARMUP + CNN_TIMED):
                before, cache0 = _counts(), _cache_counts()
                module, opt_state, hist = trainer.run(1, module, opt_state,
                                                      start_step=s)
                after = _counts()
                steps.append({**hist[0], "launches": {
                    k: after[k] - before[k] for k in after},
                    **_cache_delta(cache0),
                    "overlap": _overlap_summary(trainer)})
            totals = _counts()                # main path ends here
            scalar = _scalar_counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            runs.append({
                "model": name, "strategy": strategy, "transport": transport,
                "steps": steps,
                "totals": totals, "scalar": scalar, "peak_gib": peak_gib,
                "n_params": sum(p.numel() for p in module.parameters()),
                "checksum": _checksum(module.tree()),
                "breakdown": None if overlap else _step_breakdown(
                    trainer, module, "cuda", CNN_WARMUP + CNN_TIMED, rank,
                    world)})
            del trainer, module, opt_state
            plan_cache.GLOBAL_EXECUTOR_CACHE.clear()   # frees the slots
            torch.cuda.empty_cache()

    # Small reference check: float32 MobileNet-v1 at image 32 under fused
    # ps_gather on the card (K4) and on the host (its plain version).
    losses, init = {}, None
    for device in ("cpu", "cuda"):
        small = cnn_trainer("mobilenet", "ps_gather", 32, 2 * world,
                            "float32", device, groups[transports[0]])
        if init is None:
            init = small.init_state(0)[0].tree()
        mod = ParamTree(tree.tree_map(
            lambda t: t.detach().clone().to(device), init))
        mod, _, hist = small.run(2, mod, small.optimizer.init(mod.tree()))
        losses[device] = [h["loss"] for h in hist]
    return {"rank": rank, "runs": runs, "small_losses": losses}


def run_cnn_phase(runs=CNN_RUNS, transports=("gloo",),
                  deterministic=False, overlap=False):
    """Spawn the 4 ranks once, then train every model and strategy of
    ``runs`` on each of ``transports`` in turn (cuDNN's deterministic
    algorithms with ``deterministic``), and require for each: finite
    losses, one parameter checksum on every rank, K4 launched once per
    bucket per step exactly under fused ps_gather and never otherwise,
    no other kernel launched, executors built once and plan-cache hits
    only from step 2 (on cuda_ipc, an aggregate with no host copy); then
    the small card-vs-host agreement.  With ``overlap`` the buckets are
    reduced inside the backward, and no aggregate is timed alone (each
    step's channel staged nothing on cuda_ipc).  Returns each rank's
    record."""
    from repro_torch.core.dist import run_ranks
    for t in transports:
        log(f"  transport: {t}, {TRANSPORT_NOTE[t]}")
    log(f"  {CNN_WORLD} ranks on one card; global batch "
        f"{CNN_BATCH} ({CNN_BATCH // CNN_WORLD} per rank) at "
        f"{CNN_IMAGE}x{CNN_IMAGE}, bf16, cuDNN "
        f"{'deterministic' if deterministic else 'default'} algorithms; "
        f"{CNN_WARMUP} warm-up + {CNN_TIMED} timed steps per model and "
        f"strategy{'; buckets reduced inside the backward' if overlap else ''}")
    backend = "cuda_ipc" if "cuda_ipc" in transports else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(cnn_rank, CNN_WORLD,
                            (runs, transports, deterministic, overlap),
                            backend=backend, rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1)
                                        // CNN_WORLD),
                            timeout_s=900)
    log(f"  {CNN_WORLD} ranks done in {time.perf_counter() - t0:.1f} s")
    for i, run in enumerate(results[0]["runs"]):
        model, strategy, transport = (run["model"], run["strategy"],
                                      run["transport"])
        buckets = CNN_BUCKETS[model]
        k4_per_step = buckets if strategy == "ps_gather" else 0
        timed = run["steps"][CNN_WARMUP:]
        step_s = sum(r["step_s"] for r in timed) / len(timed)
        log(f"  {model} {strategy}{' (fused, K4)' if k4_per_step else ''} "
            f"on {transport}: "
            f"{run['n_params']} parameters, images/s "
            f"{CNN_BATCH / step_s:.1f}, timed step_s "
            f"{[round(r['step_s'], 4) for r in timed]}, warm-up "
            f"{run['steps'][0]['step_s']:.3f} s, losses "
            f"{[round(r['loss'], 5) for r in run['steps']]}, buckets "
            f"{run['steps'][0]['n_buckets']}, peak GiB per rank "
            f"{[round(r['runs'][i]['peak_gib'], 2) for r in results]}")
        for r in results:
            rr = r["runs"][i]
            require((rr["model"], rr["strategy"], rr["transport"])
                    == (model, strategy, transport),
                    "ranks ran the strategies in different orders")
            bd = rr["breakdown"]
            if bd is not None:
                log(f"    rank {r['rank']} layers, one step timed alone "
                    f"after the main path: " + ", ".join(
                        f"{k} {bd[k]:.3f}" for k in (
                            "fwd_bwd_s", "aggregate_s", "optimizer_s")))
                if r["rank"] == 0:
                    log(f"      {_traffic_line(bd)}")
                if transport == "cuda_ipc":
                    _require_on_card(bd, f"rank {r['rank']} {model} "
                                         f"{strategy}")
            else:
                _require_overlapped(f"rank {r['rank']} {model} {strategy}",
                                    rr["steps"], transport)
            _require_cached(r["rank"], f"{model} {strategy} {transport}",
                            rr["steps"])
            require(all(math.isfinite(s_["loss"]) for s_ in rr["steps"]),
                    f"rank {r['rank']} {model} {strategy}: non-finite loss")
            for s_, rec in enumerate(rr["steps"]):
                require(rec["n_buckets"] == buckets,
                        f"{model}: {rec['n_buckets']} buckets, not {buckets}")
                want = {k: 0 for k in rec["launches"]}
                want["fused_reduce"] = k4_per_step
                require(rec["launches"] == want,
                        f"rank {r['rank']} {model} {strategy} step {s_ + 1}:"
                        f" launches {rec['launches']}, want {want}")
        sums = {r["runs"][i]["checksum"] for r in results}
        require(len(sums) == 1, f"{model} {strategy} {transport}: "
                                f"parameters differ across ranks: {sums}")
        log(f"    K4 launches per rank per step {k4_per_step}; parameters "
            f"bit-identical on all {CNN_WORLD} ranks (checksum "
            f"{sums.pop()})")
    sl = results[0]["small_losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(sl["cpu"], sl["cuda"]))
    log(f"  small float32 MobileNet-v1 at image 32, fused ps_gather, card "
        f"vs host plain versions: losses {sl['cuda']} vs {sl['cpu']} (max "
        f"rel {rel:.2e})")
    require(rel <= 1e-3, "card and host CNN training disagree")
    return results


# ---------------------------------------------------------------------------
# phase 6: gemma-7b at full width, long context (K7/K8 at head_dim 256)
# ---------------------------------------------------------------------------

def run_gemma_phase(rows, backend="gloo"):
    """Train full-width gemma-7b, depth cut to ``GEMMA_LAYERS``, at seq
    4096 on 2 ranks through ``run_phase``; require K7 and K8 once per
    layer per step and the ranks' peaks within 90% of the card's memory;
    then the float32 gemma at head_dim 256 on the card and on the host.
    Returns each rank's record."""
    import dataclasses
    import torch
    from repro_torch.configs import get_spec
    full = get_spec("gemma-7b")
    spec = dataclasses.replace(full, num_layers=GEMMA_LAYERS)
    small_spec = dataclasses.replace(full.reduced(), head_dim=256,
                                     dtype="float32")
    log(f"  gemma-7b at full width: d_model {spec.d_model}, "
        f"{spec.num_heads}/{spec.num_kv_heads} heads of "
        f"{spec.resolved_head_dim}, d_ff {spec.d_ff}, vocab "
        f"{spec.vocab_size}, {spec.mlp_type}, tied and scaled embeddings; "
        f"depth cut to {spec.num_layers} of {full.num_layers} layers; the "
        f"small check: {small_spec.num_layers} layers, d_model "
        f"{small_spec.d_model}, head_dim {small_spec.resolved_head_dim}, "
        f"float32")
    args = train_args(arch="gemma-7b", full=True, batch=GEMMA_WORLD,
                      seq=LONG_SEQ, steps=GEMMA_STEPS, device="cuda")
    small = train_args(arch="gemma-7b", full=False, batch=2 * GEMMA_WORLD,
                       seq=128, steps=2, dtype="float32")
    results = run_phase(GEMMA_WORLD, args, small,
                        tuple(k for k in KERNELS if k != "fused_reduce"),
                        spec=spec, small_spec=small_spec, backend=backend)
    for r in results:
        for s_, rec in enumerate(r["steps"]):
            for k in ("flash_attention_fwd", "flash_attention_bwd"):
                require(rec["launches"][k] == GEMMA_LAYERS,
                        f"rank {r['rank']} step {s_ + 1}: {k} launched "
                        f"{rec['launches'][k]} times, not once per layer")
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    peaks = [r["peak_gib"] for r in results]
    # What the card holds, not what the ranks' tensors take: the card's
    # own reading at the end of the main path plus any blocks a rank's
    # allocator gave back before it.
    held = max(r["card_gib"] for r in results) + sum(
        r["released_gib"] for r in results)
    log(f"  GiB allocated at peak per rank {[round(p, 2) for p in peaks]} "
        f"({sum(peaks):.2f}, {sum(peaks) / total:.1%} of the card); the "
        f"card in use at its peak {held:.2f} of {total:.2f} GiB "
        f"({held / total:.1%})")
    require(held <= 0.9 * total,
            f"phase 6 holds {held:.2f} GiB of the card, more than 90% of "
            f"its {total:.2f}: cut GEMMA_LAYERS")
    fb = min(r["breakdown"]["fwd_bwd_s"] for r in results)
    attn_s = GEMMA_LAYERS * (
        rows["flash_attention_fwd"]["variants"]["bf16 dh256"]["ms"]
        + rows["flash_attention_bwd"]["variants"]["bf16 dh256"]["ms"]) / 1e3
    log(f"  attention kernels (K7+K8 at phase 2's dh-256 times x "
        f"{GEMMA_LAYERS} layers) {attn_s:.4f} s of the {fb:.3f} s "
        f"forward+backward of one rank alone: {attn_s / fb:.1%}")
    return results


# ---------------------------------------------------------------------------
# phase 7: phases 3, 5 and 6 on the cuda_ipc transport
# ---------------------------------------------------------------------------

TRANSPORT_CNN_RUNS = (("resnet50", ("ring_rsa", "rhd_rsa", "ps_gather")),
                      ("mobilenet", ("rhd_rsa", "ps_gather")))
HOP_KERNEL_NAMES = ("hop_absmax", "hop_encode", "hop_decode_add",
                    "fused_reduce", "adamw_update")


def _same_as(label, base, new, base_name="gloo", new_name="cuda_ipc"):
    """Every rank's parameters and K1-K5 launch counts as in the run it
    is held to (``base`` and ``new``: one record per rank)."""
    for rank, (g, i) in enumerate(zip(base, new)):
        require(g["checksum"] == i["checksum"],
                f"{label} rank {rank}: parameters differ between "
                f"{base_name} ({g['checksum']}) and {new_name} "
                f"({i['checksum']})")
        for k in HOP_KERNEL_NAMES:
            require(g["totals"][k] == i["totals"][k],
                    f"{label}: {k} launched {g['totals'][k]} times on "
                    f"{base_name}, {i['totals'][k]} on {new_name}")
    log(f"  {label}: parameters bit-identical to the {base_name} run on "
        f"every rank, K1-K5 launches equal")


def _lm_times(results):
    steps = results[0]["steps"][1:]
    return (f"step_s {[round(r['step_s'], 4) for r in steps]}, aggregate_s "
            f"{[round(r['breakdown']['aggregate_s'], 4) for r in results]}")


def _images_per_s(run):
    timed = run["steps"][CNN_WARMUP:]
    return CNN_BATCH * len(timed) / sum(r["step_s"] for r in timed)


def run_transport_phase(rows, phase3, phase5, phase6):
    """Phases 3 and 6 again on cuda_ipc, each held bit for bit to its gloo
    run; phase 5's ResNet-50 under ring_rsa, rhd_rsa and ps_gather and
    MobileNet-v1 under rhd_rsa and ps_gather on gloo and on cuda_ipc in
    one spawn under deterministic cuDNN, held bit for bit to each other.
    Prints both transports' times beside the card, and phase 5's
    images/s beside phase 7's on gloo."""
    log("  smollm-360m, seq 512, 4 ranks (phase 3's configuration)")
    args = train_args(full=True, batch=2 * TRAIN_WORLD, seq=512,
                      device="cuda")
    small = train_args(full=False, batch=2 * TRAIN_WORLD, seq=32, steps=2,
                       dtype="float32")
    lm = run_phase(TRAIN_WORLD, args, small,
                   ("hop_absmax", "hop_encode", "hop_decode_add",
                    "adamw_update", "fused_rmsnorm"), backend="cuda_ipc",
                   profile=True)
    _same_as("smollm-360m", phase3, lm)
    log("  the paper's CNNs (phase 5's configurations), gloo then cuda_ipc")
    cnn = run_cnn_phase(TRANSPORT_CNN_RUNS, ("gloo", "cuda_ipc"),
                        deterministic=True)

    def by_run(results):
        """(model, strategy, transport) -> one record per rank."""
        return {(run["model"], run["strategy"], run["transport"]):
                [r["runs"][i] for r in results]
                for i, run in enumerate(results[0]["runs"])}

    phase5_runs, cnn_runs = by_run(phase5), by_run(cnn)
    for model, strategies in TRANSPORT_CNN_RUNS:
        for strategy in strategies:
            _same_as(f"{model} {strategy}",
                          cnn_runs[(model, strategy, "gloo")],
                          cnn_runs[(model, strategy, "cuda_ipc")])
    log("  gemma-7b, 1 layer, seq 4096, 2 ranks (phase 6's configuration)")
    gemma = run_gemma_phase(rows, backend="cuda_ipc")
    _same_as("gemma-7b", phase6, gemma)

    log(f"  both transports on {gpu_line()}:")
    log(f"    smollm-360m seq 512: gloo {_lm_times(phase3)}; cuda_ipc "
        f"{_lm_times(lm)}")
    log(f"    gemma-7b seq 4096: gloo {_lm_times(phase6)}; cuda_ipc "
        f"{_lm_times(gemma)}")
    for model, strategies in TRANSPORT_CNN_RUNS:
        for strategy in strategies:
            for label, recs in (
                    ("gloo, default cuDNN (phase 5)",
                     phase5_runs[(model, strategy, "gloo")]),
                    ("gloo, deterministic cuDNN",
                     cnn_runs[(model, strategy, "gloo")]),
                    ("cuda_ipc, deterministic cuDNN",
                     cnn_runs[(model, strategy, "cuda_ipc")])):
                timed = recs[0]["steps"][CNN_WARMUP:]
                agg_s = [round(r["breakdown"]["aggregate_s"], 4)
                         for r in recs]
                log(f"    {model} {strategy} {label}: images/s "
                    f"{_images_per_s(recs[0]):.1f}, step_s "
                    f"{[round(r['step_s'], 4) for r in timed]}, "
                    f"aggregate_s {agg_s}")
    return {"lm": lm, "cnn": cnn, "gemma": gemma}


# ---------------------------------------------------------------------------
# phase 8: strategy="auto" and overlap=True
# ---------------------------------------------------------------------------

# (label, strategy, overlap): rhd_rsa is held to phase 7's cuda_ipc run;
# auto, under _mixed_table, is held to its own post-backward run.
OVERLAP_RUNS = (("rhd_rsa overlap", "rhd_rsa", True),
                ("auto overlap", "auto", True),
                ("auto post-backward", "auto", False))
# A forced tuning table: rhd_rsa below 64 MiB, ring_rsa from there on.
# smollm-360m's buckets span 0.09-118 MB, so one backward runs both
# algorithms, and the executor sizes its slots from both.
MIXED_SWITCH_BYTES = 64 << 20
OVERLAP_CNN_RUNS = (("resnet50", ("rhd_rsa",)),)
LM_KERNELS = ("hop_absmax", "hop_encode", "hop_decode_add", "adamw_update",
              "fused_rmsnorm")


def _overlap_summary(trainer):
    """The overlapped step's channel record (None after a post-backward
    step): each bucket's host seconds from the start of backward (ready,
    start, end), the bytes the transport moved meanwhile, and the
    measured timeline beside ``overlap.simulate``'s, fed with the
    measured ready and communication times."""
    rec = trainer.extras["aggregator"].last_overlap
    if rec is None:
        return None
    return {"backward_s": rec.backward_s,
            "buckets": [(b.index, b.strategy, b.ready_s, b.start_s,
                         b.end_s) for b in rec.buckets],
            "traffic": rec.traffic,
            "measured": rec.timeline().to_dict(),
            "simulated": rec.simulated().to_dict()}


def _require_overlapped(label, steps, transport, early=True):
    """Every step reduced every bucket on the channel; on cuda_ipc it
    staged nothing through the host; with ``early`` the first bucket's
    reduction started before backward ended."""
    for s_, rec in enumerate(steps, 1):
        ov = rec["overlap"]
        require(ov is not None and len(ov["buckets"]) == rec["n_buckets"],
                f"{label} step {s_}: the channel did not reduce every "
                f"bucket: {ov}")
        if transport == "cuda_ipc":
            t = ov["traffic"]
            require(t["staged_bytes"] == 0 and t["mapped_bytes"] > 0,
                    f"{label} step {s_}: the channel staged through the "
                    f"host: {t}")
        if early:
            start = ov["buckets"][0][3]
            require(start < ov["backward_s"],
                    f"{label} step {s_}: the first bucket's reduction "
                    f"started at {start:.4f} s, after backward ended at "
                    f"{ov['backward_s']:.4f} s")


def _overlap_lines(label, results, steps_of):
    """Rank 0's last step bucket by bucket, then every rank's last step:
    backward, the first bucket's start, hidden and exposed
    communication, and the measured overlap beside the simulator's."""
    ov = steps_of(results[0])[-1]["overlap"]
    log(f"    {label}, rank 0, last step, channel order (ms from the start "
        f"of backward; backward {ov['backward_s'] * 1e3:.2f}):")
    for index, strategy, ready, start, end in ov["buckets"]:
        log(f"      bucket {index:3d} {strategy:8s} ready {ready * 1e3:8.2f} "
            f"start {start * 1e3:8.2f} end {end * 1e3:8.2f}")
    for r in results:
        ov = steps_of(r)[-1]["overlap"]
        m, sim = ov["measured"], ov["simulated"]
        log(f"    {label}, rank {r['rank']}: backward "
            f"{ov['backward_s'] * 1e3:.2f} ms, first bucket started "
            f"{ov['buckets'][0][3] * 1e3:.2f} ms; communication "
            f"{m['comm_s'] * 1e3:.2f} ms, hidden {m['hidden_comm_s'] * 1e3:.2f}"
            f", exposed {m['exposed_comm_s'] * 1e3:.2f}; overlap fraction "
            f"measured {m['overlap_fraction']:.3f}, overlap.simulate "
            f"{sim['overlap_fraction']:.3f} (hidden "
            f"{sim['hidden_comm_s'] * 1e3:.2f}, exposed "
            f"{sim['exposed_comm_s'] * 1e3:.2f})")


def _mixed_table(p):
    from repro_torch.core.selector import TABLE_SCHEMA
    return {"schema": TABLE_SCHEMA, "entries": [
        {"p": p, "bytes": 0, "latency_us": {"rhd_rsa": 1.0, "ring_rsa": 5.0}},
        {"p": p, "bytes": MIXED_SWITCH_BYTES,
         "latency_us": {"rhd_rsa": 5.0, "ring_rsa": 1.0}}]}


def _overlap_config(args, overlap, table):
    """The aggregator configuration the launcher builds from ``args``,
    with ``overlap`` set on it as a ``Trainer`` user sets it, and
    strategy="auto" reading the tuning table at ``table``."""
    import dataclasses
    from repro_torch.launch.train import aggregator_config
    cfg = dataclasses.replace(aggregator_config(args), overlap=overlap)
    if cfg.strategy == "auto":
        cfg = dataclasses.replace(cfg, selector_mode="empirical",
                                  selector_table=table)
    return cfg


def overlap_rank(rank, world, args, runs_spec, table):
    """Train ``args`` once per ``(label, strategy, overlap)`` of
    ``runs_spec`` (:func:`_overlap_config`), counting launches, cache use
    and the channel's record per step."""
    import torch
    from repro_torch.core import Group, plan_cache
    from repro_torch.launch.train import build_trainer

    if args.device == "cuda":
        torch.cuda.set_device(0)
    group = Group()
    runs = []
    for label, strategy, overlap in runs_spec:
        a = argparse.Namespace(**{**vars(args), "strategy": strategy})
        trainer = build_trainer(a, verbose=False, groups={"data": group},
                                aggregator=_overlap_config(a, overlap,
                                                           table))
        module, opt_state = trainer.init_state(args.seed)
        steps = []
        _reset_counts()                       # main path starts here
        for s in range(args.steps):
            before, cache0 = _counts(), _cache_counts()
            module, opt_state, hist = trainer.run(1, module, opt_state,
                                                  start_step=s)
            after = _counts()
            steps.append({**hist[0], "launches": {k: after[k] - before[k]
                                                  for k in after},
                          **_cache_delta(cache0),
                          "overlap": _overlap_summary(trainer)})
        totals = _counts()                    # main path ends here
        sched = trainer.extras["aggregator"].last_schedule
        runs.append({"label": label, "strategy": strategy,
                     "overlap": overlap, "steps": steps, "totals": totals,
                     "scalar": _scalar_counts(),
                     "checksum": _checksum(module.tree()),
                     "buckets": [(b.index, b.strategy, b.leaf_indices)
                                 for b in sched.buckets],
                     "fingerprint": sched.fingerprint()})
        del trainer, module, opt_state
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()     # frees the slots
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return {"rank": rank, "runs": runs}


def _host_plan(args, world, table):
    """``strategy="auto"``'s schedule of ``args``' model under the tuning
    table at ``table``, planned on the host (meta tensors, no rank), as
    the ranks' aggregators resolve it."""
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.core import GradientAggregator, Group
    from repro_torch.models import param_groups
    from repro_torch.models.transformer import init_params
    spec = get_spec(args.arch)
    with torch.device("meta"):
        params = init_params(torch.Generator(),
                             spec if args.full else spec.reduced(), "meta")
    agg = GradientAggregator(_overlap_config(args, True, table), ("data",),
                             {"data": Group()})
    return agg.resolve(params, (world,), groups=param_groups(params))


def run_overlap_phase(phase7):
    """Phase 7's smollm-360m on cuda_ipc with overlap=True under rhd_rsa +
    int8, held bit for bit to phase 7's cuda_ipc run; under
    strategy="auto" with a tuning table that mixes rhd_rsa and ring_rsa,
    its buckets held to a host plan and its parameters to a post-backward
    run of the same schedule; and phase 7's ResNet-50 rhd_rsa with
    overlap=True under deterministic cuDNN, held to phase 7's cuda_ipc
    run.  Returns each run's records."""
    from repro_torch.core.dist import run_ranks
    args = train_args(full=True, batch=2 * TRAIN_WORLD, seq=512,
                      device="cuda")
    log(f"  smollm-360m, seq 512, {TRAIN_WORLD} ranks on cuda_ipc (phase "
        f"7's configuration) + int8, {args.steps} steps per run: "
        f"{[label for label, _, _ in OVERLAP_RUNS]}; overlap runs reduce "
        f"their buckets inside the backward on a channel of their own; "
        f"auto reads a tuning table that picks rhd_rsa below "
        f"{MIXED_SWITCH_BYTES} B and ring_rsa from there on")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        table = os.path.join(rdv, "mixed_table.json")
        with open(table, "w") as f:
            json.dump(_mixed_table(TRAIN_WORLD), f)
        host = _host_plan(argparse.Namespace(**{**vars(args),
                                                "strategy": "auto"}),
                          TRAIN_WORLD, table)
        results = run_ranks(overlap_rank, TRAIN_WORLD,
                            (args, OVERLAP_RUNS, table), backend="cuda_ipc",
                            rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1)
                                        // TRAIN_WORLD),
                            timeout_s=600)
    log(f"  {TRAIN_WORLD} ranks done in {time.perf_counter() - t0:.1f} s")
    by = {label: [r["runs"][i] for r in results]
          for i, (label, _, _) in enumerate(OVERLAP_RUNS)}
    for label, recs in by.items():
        name = f"smollm-360m {label}"
        for rank, rec in enumerate(recs):
            require(rec["label"] == label,
                    "ranks ran the configurations in different orders")
            _require_cached(rank, name, rec["steps"])
            if rec["overlap"]:
                # Every smollm bucket holds leaves stacked over the 32
                # layers or the tied embedding: each is complete only
                # when backward reaches layer 0 and the embedding, at its
                # very end.  So the first bucket's start is printed here,
                # and required before the end of backward on ResNet-50,
                # whose last stage's bucket is complete early.
                _require_overlapped(f"rank {rank} {name}", rec["steps"],
                                    "cuda_ipc", early=False)
            else:
                require(all(s_["overlap"] is None for s_ in rec["steps"]),
                        f"rank {rank} {name}: a post-backward step ran "
                        f"the channel")
            require(all(rec["totals"][k] > 0 for k in LM_KERNELS),
                    f"rank {rank} {name}: a kernel never launched "
                    f"{rec['totals']}")
            require(all(math.isfinite(s_["loss"]) for s_ in rec["steps"]),
                    f"rank {rank} {name}: non-finite loss")
        sums = {rec["checksum"] for rec in recs}
        require(len(sums) == 1, f"{name}: parameters differ across ranks "
                                f"{sums}")
        for s_, step in enumerate(recs[0]["steps"], 1):
            log(f"  {name} step {s_}: loss {step['loss']:.5f} step_s "
                f"{step['step_s']:.3f} buckets {step['n_buckets']} "
                f"launches/rank {step['launches']}")
        log(f"  {name}: parameters bit-identical on all {TRAIN_WORLD} "
            f"ranks (checksum {sums.pop()}), executors built once")
    _same_as("smollm-360m rhd_rsa overlap", phase7["lm"],
             by["rhd_rsa overlap"], "phase 7 cuda_ipc", "overlap")
    want = [(b.index, b.strategy, b.leaf_indices) for b in host.buckets]
    require({st for _, st, _ in want} == {"rhd_rsa", "ring_rsa"},
            f"the mixed table's host plan does not mix rhd_rsa and "
            f"ring_rsa: {want}")
    for label in ("auto overlap", "auto post-backward"):
        for rank, rec in enumerate(by[label]):
            # The host plan is the overlapped one: its fingerprint also
            # names the placement.
            require([tuple(b) for b in rec["buckets"]] == want
                    and (rec["fingerprint"] == host.fingerprint())
                    == rec["overlap"],
                    f"rank {rank} {label}: buckets {rec['buckets']} are "
                    f"not the host plan's {want}")
    log(f"  auto: each bucket's algorithm, as a host plan() of the same "
        f"tree and table chose it: "
        + ", ".join(f"{i}:{st}" for i, st, _ in want))
    _same_as("smollm-360m auto overlap", by["auto post-backward"],
             by["auto overlap"], "auto post-backward", "auto overlap")
    for label, recs in by.items():
        if recs[0]["overlap"]:
            _overlap_lines(f"smollm-360m {label}",
                           [{"rank": i, **rec} for i, rec in enumerate(recs)],
                           lambda r: r["steps"])

    log("  ResNet-50 rhd_rsa on cuda_ipc, overlap=True (phase 7's "
        "configuration)")
    cnn = run_cnn_phase(OVERLAP_CNN_RUNS, ("cuda_ipc",), deterministic=True,
                        overlap=True)
    ipc7 = {(run["model"], run["strategy"]): [r["runs"][i]
                                              for r in phase7["cnn"]]
            for i, run in enumerate(phase7["cnn"][0]["runs"])
            if run["transport"] == "cuda_ipc"}
    for i, run in enumerate(cnn[0]["runs"]):
        key = (run["model"], run["strategy"])
        _same_as(f"{key[0]} {key[1]} overlap", ipc7[key],
                 [r["runs"][i] for r in cnn], "phase 7 cuda_ipc", "overlap")
        _overlap_lines(f"{key[0]} {key[1]}",
                       [{"rank": r["rank"], **r["runs"][i]} for r in cnn],
                       lambda r: r["steps"])

    log(f"  step time beside phase 7's on {gpu_line()}:")
    log(f"    smollm-360m seq 512 phase 7 cuda_ipc: "
        f"{[round(s_['step_s'], 4) for s_ in phase7['lm'][0]['steps']]}")
    for label, recs in by.items():
        log(f"    smollm-360m seq 512 {label}: "
            f"{[round(s_['step_s'], 4) for s_ in recs[0]['steps']]}")
    for i, run in enumerate(cnn[0]["runs"]):
        key = (run["model"], run["strategy"])
        for label, rec in (("phase 7 cuda_ipc", ipc7[key][0]),
                           ("overlap", run)):
            log(f"    {key[0]} {key[1]} {label}: images/s "
                f"{_images_per_s(rec):.1f}, step_s "
                f"{[round(s_['step_s'], 4) for s_ in rec['steps']]}")
    return {"lm": results, "cnn": cnn}


# ---------------------------------------------------------------------------
# phase 9: two dp axes, pod x data
# ---------------------------------------------------------------------------

PODS, POD_DATA = 2, 2                 # the mesh: 2 pods of 2 ranks
TWO_AXIS_MESH = f"{PODS}x{POD_DATA}x1"
COMPOSED = "ring_rsa×rhd_rsa"
LEVEL_CODECS = "bf16×int8"            # bf16 inside a pod, int8 across pods
# (label, transport, strategy, overlap): gloo, cuda_ipc and cuda_ipc
# overlapped are held to each other bit for bit; auto, under
# _axes_table, is held to its own post-backward run.
TWO_AXIS_RUNS = (("gloo", "gloo", COMPOSED, False),
                 ("cuda_ipc", "cuda_ipc", COMPOSED, False),
                 ("cuda_ipc overlap", "cuda_ipc", COMPOSED, True),
                 ("auto overlap", "cuda_ipc", "auto", True),
                 ("auto post-backward", "cuda_ipc", "auto", False))


TWO_AXIS_CNN_STEPS = 2    # ResNet-50 on the composed schedule, each transport


def _axes_table():
    """A forced two-axis tuning table: the flat RHD fold below 64 MiB,
    the composed schedule from there on, so one step runs both."""
    from repro_torch.core.selector import TABLE_SCHEMA
    axes = [PODS, POD_DATA]
    return {"schema": TABLE_SCHEMA, "entries": [
        {"p": PODS * POD_DATA, "axes": axes, "bytes": 0,
         "latency_us": {"rhd_rsa": 1.0, COMPOSED: 5.0}},
        {"p": PODS * POD_DATA, "axes": axes, "bytes": MIXED_SWITCH_BYTES,
         "latency_us": {"rhd_rsa": 5.0, COMPOSED: 1.0}}]}


def _plan_hop_launches(sched):
    """K1-K3 launches one aggregate of ``sched`` makes on every rank.  A
    fused stage's accumulating hop encodes (K1 when the codec has a
    scale, K2 when it has a codec) and decodes onto its partial sum
    (K3); a forwarding hop encodes and decodes both what it received and
    what it sent (K3 twice), once per block it carries when the codec is
    scaled (RHD's joined chunks), or, uncoded, launches nothing.  An
    unfused stage (the all-gather leg) runs the plain torch versions."""
    from repro_torch.analysis.hop_lint import stage_hops
    from repro_torch.core import codec
    n = {"hop_absmax": 0, "hop_encode": 0, "hop_decode_add": 0}
    for b in sched.buckets:
        for st in b.stages:
            if not st.fused_hop:
                continue
            acc, fwd, blocks = stage_hops(st)
            coded = st.codec != "none"
            scaled = codec.get(st.codec).scaled
            units = blocks if scaled else fwd
            n["hop_absmax"] += (acc + units) * scaled
            n["hop_encode"] += (acc + units) * coded
            n["hop_decode_add"] += acc + 2 * units * coded
    return n


def _hops_per_axis(bucket):
    from repro_torch.analysis.hop_lint import stage_hops
    hops = {}
    for st in bucket.stages:
        acc, fwd, _ = stage_hops(st)
        hops[st.axis] = hops.get(st.axis, 0) + acc + fwd
    return hops


def _grown_bound(stages):
    """The error bound of a coded reduction relative to the largest
    input absmax: per coded stage ``codec.tolerance`` over the stage's
    hops (``allreduce_steps`` of an allreduce, size-1 of a reduce-scatter
    or all-gather), scaled by the magnitude its hops carry when the
    ranks' inputs are alike (gradients of one model): the input absmax
    times the sizes of the axes reduced before the stage, times the
    stage's own size where it sums (int8's tolerance already holds that
    growth)."""
    from repro_torch.core import codec, reducers
    total, grown = 0.0, 1
    for st in stages:
        sums = st.op in ("reduce_scatter", "allreduce")
        if st.codec != "none":
            hops = reducers.allreduce_steps(st.algorithm, st.axis_size) \
                if st.op == "allreduce" else st.axis_size - 1
            within = st.axis_size if sums and st.codec != "int8" else 1
            total += codec.tolerance(st.codec, st.axis_size, hops=hops) \
                * grown * within
        if sums:
            grown *= st.axis_size
    return total


def _two_axis_config(args, strategy, overlap, table):
    return _overlap_config(
        argparse.Namespace(**{**vars(args), "strategy": strategy}),
        overlap, table)


def _gradient_check(args, trainer, groups):
    """Step 1's local gradient, aggregated by the composed schedule
    (``trainer``'s aggregator) and by phase 7's flat ``rhd_rsa`` + int8
    over the 4 ranks, and both schedules uncoded, each timed alone (its
    second call, after the executor's build).  Per bucket, the two coded
    means may differ by the sum of both bounds (:func:`_grown_bound`)
    times the bucket's largest input absmax on any rank, over 4.
    Returns the largest difference over its bound and the four
    aggregates' seconds."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.core import AggregatorConfig, GradientAggregator, Group
    from repro_torch.launch.mesh import DP_AXES
    from repro_torch.models import param_groups
    from repro_torch.train.step import shard_batch

    sync = torch.cuda.synchronize if args.device == "cuda" \
        else (lambda: None)
    module, _ = trainer.init_state(args.seed)
    params = module.tree()
    agg = trainer.extras["aggregator"]
    batch = {k: v.to(args.device) for k, v in shard_batch(
        trainer.data_iter_fn(0), [groups[a] for a in agg.dp_axes]).items()}
    loss, _ = trainer.model.loss(params, batch)
    loss.backward()
    grads = tree.tree_map(lambda p: p.grad, params)
    pg = param_groups(params)
    world = {"data": Group()}
    flat = GradientAggregator(AggregatorConfig(
        strategy="rhd_rsa", codec="int8"), ("data",), world)
    out, secs = {}, {}
    for name, a in (
            ("composed", agg), ("flat", flat),
            ("composed uncoded", GradientAggregator(
                AggregatorConfig(strategy=COMPOSED), DP_AXES, groups)),
            ("flat uncoded", GradientAggregator(
                AggregatorConfig(strategy="rhd_rsa"), ("data",), world))):
        for _ in range(2):
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            reduced = a(grads, groups=pg)
            sync()
            secs[name] = time.perf_counter() - t0
        if name in ("composed", "flat"):
            out[name] = reduced
        del reduced
    sched, fsched = agg.last_schedule, flat.last_schedule
    require([b.leaf_indices for b in sched.buckets]
            == [b.leaf_indices for b in fsched.buckets],
            "the composed and flat plans bucket the tree differently")
    local = tree.leaves(grads)
    absmax = torch.tensor([max(float(local[i].abs().max())
                               for i in b.leaf_indices)
                           for b in sched.buckets])
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX)
    worst = 0.0
    got, want = tree.leaves(out["composed"]), tree.leaves(out["flat"])
    for b, fb, m in zip(sched.buckets, fsched.buckets, absmax.tolist()):
        bound = (_grown_bound(b.stages) + _grown_bound(fb.stages)) * m \
            / (PODS * POD_DATA)
        diff = max(float((got[i].float() - want[i].float()).abs().max())
                   for i in b.leaf_indices)
        require(diff <= bound, f"bucket {b.index}: the composed gradient "
                               f"is {diff:.3e} from flat rhd_rsa + int8, "
                               f"over the bound {bound:.3e}")
        worst = max(worst, diff / bound)
    for p in tree.leaves(params):
        p.grad = None
    return {"worst_ratio": worst, "secs": secs,
            "n_buckets": len(sched.buckets),
            "bound_rel": _grown_bound(sched.buckets[0].stages)
            + _grown_bound(fsched.buckets[0].stages)}


def two_axis_rank(rank, world, args, table):
    """Train ``args`` on the 2 x 2 mesh once per run of
    :data:`TWO_AXIS_RUNS`, every group built by ``launch.mesh.make_groups``
    (the gloo groups first, then the cuda_ipc ones, on every rank),
    counting launches, cache use, the channel's record and the traffic
    of an aggregate timed alone; after the cuda_ipc run, the gradient
    check against flat rhd_rsa + int8."""
    import torch
    from repro_torch.core import plan_cache
    from repro_torch.launch.mesh import make_groups
    from repro_torch.launch.train import build_trainer

    if args.device == "cuda":
        torch.cuda.set_device(0)
    groups = {"gloo": make_groups(PODS, POD_DATA, transport="gloo"),
              "cuda_ipc": make_groups(PODS, POD_DATA)}
    require(groups["cuda_ipc"]["pod"].transport == "cuda_ipc",
            "the mesh's groups are not on cuda_ipc")
    runs, check = [], None
    for label, transport, strategy, overlap in TWO_AXIS_RUNS:
        g = groups[transport]
        trainer = build_trainer(args, verbose=False, groups=g,
                                aggregator=_two_axis_config(
                                    args, strategy, overlap, table))
        module, opt_state = trainer.init_state(args.seed)
        steps = []
        _reset_counts()                       # main path starts here
        for s in range(args.steps):
            before, cache0 = _counts(), _cache_counts()
            module, opt_state, hist = trainer.run(1, module, opt_state,
                                                  start_step=s)
            after = _counts()
            steps.append({**hist[0], "launches": {k: after[k] - before[k]
                                                  for k in after},
                          **_cache_delta(cache0),
                          "overlap": _overlap_summary(trainer)})
        totals = _counts()                    # main path ends here
        agg = trainer.extras["aggregator"]
        sched = agg.last_schedule
        ex = plan_cache.GLOBAL_EXECUTOR_CACHE.executor_for(
            sched, agg.groups, args.device)
        rec = {"label": label, "transport": transport, "overlap": overlap,
               "steps": steps, "totals": totals,
               "scalar": _scalar_counts(),
               "checksum": _checksum(module.tree()),
               "buckets": [(b.index, b.strategy, b.leaf_indices)
                           for b in sched.buckets],
               "render": sched.render(),
               "bucket_renders": [b.render() for b in sched.buckets],
               "hops": [_hops_per_axis(b) for b in sched.buckets],
               "plan_launches": _plan_hop_launches(sched),
               "fingerprint": sched.fingerprint(),
               "channels": [(ch.group.name, ch.slot_bytes)
                            for ch in ex.channels]}
        del opt_state
        rec["breakdown"] = _step_breakdown(trainer, module, args.device,
                                           args.steps, rank, world)
        del module
        if label == "cuda_ipc":
            check = _gradient_check(args, trainer, g)
        runs.append(rec)
        del trainer
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()     # closes the channels
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return {"rank": rank, "runs": runs, "check": check,
            "cnn": _two_axis_cnn(groups, args.device)}


def _two_axis_cnn(groups, device):
    """ResNet-50 on the 2 x 2 mesh under the composed schedule (uncoded),
    on gloo and then on cuda_ipc, under deterministic cuDNN, 2 steps
    each: each transport's parameters, launches, losses and plan."""
    import torch
    from repro_torch.core import plan_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    for transport in ("gloo", "cuda_ipc"):
        trainer = cnn_trainer("resnet50", COMPOSED, CNN_IMAGE, CNN_BATCH,
                              "bfloat16", device, None, data_device=device,
                              groups=groups[transport])
        module, opt_state = trainer.init_state(0)
        _reset_counts()                       # main path starts here
        module, opt_state, hist = trainer.run(TWO_AXIS_CNN_STEPS, module,
                                              opt_state)
        out[transport] = {"totals": _counts(),   # main path ends here
                          "losses": [h["loss"] for h in hist],
                          "step_s": [h["step_s"] for h in hist],
                          "checksum": _checksum(module.tree()),
                          "render": trainer.extras["aggregator"]
                          .last_schedule.render()}
        del trainer, module, opt_state
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
        if device == "cuda":
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def _host_two_axis_plan(args, table):
    """``auto``'s schedule of the full-width tree under ``table`` on the
    2 x 2 mesh, planned on the host (meta tensors, no rank)."""
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.core import GradientAggregator, Group
    from repro_torch.launch.mesh import DP_AXES
    from repro_torch.models import param_groups
    from repro_torch.models.transformer import init_params
    spec = get_spec(args.arch)
    with torch.device("meta"):
        params = init_params(torch.Generator(),
                             spec if args.full else spec.reduced(), "meta")
    agg = GradientAggregator(_two_axis_config(args, "auto", True, table),
                             DP_AXES, {ax: Group(name=ax) for ax in DP_AXES})
    return agg.resolve(params, (PODS, POD_DATA), groups=param_groups(params))


def run_two_axis_phase(phase7):
    """Full-width smollm-360m on 4 ranks of the card laid out 2 pods x 2
    (dp axes pod, data), ``ring_rsa×rhd_rsa`` + ``bf16×int8`` fused hops
    and K5, 3 steps per run, in one spawn: on gloo, on cuda_ipc (one
    channel per axis), on cuda_ipc overlapped, each rank's parameters bit
    for bit across the three; ``auto`` under a forced two-axis table,
    its buckets as a host plan chose them and its parameters as its
    post-backward run's.  Then the gradient check and each run's times
    beside phase 7's flat rhd_rsa + int8.  Returns each run's records."""
    from repro_torch.core.dist import run_ranks
    args = train_args(full=True, batch=2 * PODS * POD_DATA, seq=512,
                      device="cuda", strategy=COMPOSED, codec=LEVEL_CODECS,
                      mesh=TWO_AXIS_MESH)
    log(f"  smollm-360m, seq 512, mesh {TWO_AXIS_MESH} (dp axes pod, data; "
        f"{PODS * POD_DATA} ranks on one card), {COMPOSED} + "
        f"{LEVEL_CODECS}, batch {args.batch // (PODS * POD_DATA)} per rank, "
        f"{args.steps} steps per run: "
        f"{[label for label, *_ in TWO_AXIS_RUNS]}; auto reads a table that "
        f"picks the flat rhd_rsa fold below {MIXED_SWITCH_BYTES} B and "
        f"{COMPOSED} from there on")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        table = os.path.join(rdv, "axes_table.json")
        with open(table, "w") as f:
            json.dump(_axes_table(), f)
        host = _host_two_axis_plan(args, table)
        results = run_ranks(two_axis_rank, PODS * POD_DATA, (args, table),
                            backend="cuda_ipc", rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1)
                                        // (PODS * POD_DATA)),
                            timeout_s=600)
    log(f"  {PODS * POD_DATA} ranks done in {time.perf_counter() - t0:.1f} s")
    by = {label: [r["runs"][i] for r in results]
          for i, (label, *_) in enumerate(TWO_AXIS_RUNS)}
    for label, recs in by.items():
        name = f"smollm-360m {TWO_AXIS_MESH} {label}"
        for rank, rec in enumerate(recs):
            require(rec["label"] == label,
                    "ranks ran the configurations in different orders")
            _require_cached(rank, name, rec["steps"])
            if rec["overlap"]:
                _require_overlapped(f"rank {rank} {name}", rec["steps"],
                                    "cuda_ipc", early=False)
            if rec["transport"] == "cuda_ipc":
                _require_on_card(rec["breakdown"], f"rank {rank} {name}")
                require(sorted(ax for ax, _ in rec["channels"])
                        == ["data", "pod"],
                        f"rank {rank} {name}: channels {rec['channels']}, "
                        f"not one per axis")
            require(all(rec["totals"][k] > 0 for k in LM_KERNELS),
                    f"rank {rank} {name}: a kernel never launched "
                    f"{rec['totals']}")
            require(all(math.isfinite(s_["loss"]) for s_ in rec["steps"]),
                    f"rank {rank} {name}: non-finite loss")
            want = rec["plan_launches"]
            for s_, step in enumerate(rec["steps"], 1):
                got = {k: step["launches"][k] for k in want}
                require(got == want, f"rank {rank} {name} step {s_}: K1-K3 "
                                     f"launched {got}, the plan's hops "
                                     f"imply {want}")
        sums = {rec["checksum"] for rec in recs}
        require(len(sums) == 1, f"{name}: parameters differ across ranks "
                                f"{sums}")
        rec = recs[0]
        for s_, step in enumerate(rec["steps"], 1):
            log(f"  {name} step {s_}: loss {step['loss']:.5f} step_s "
                f"{step['step_s']:.3f} buckets {step['n_buckets']} "
                f"launches/rank {step['launches']}")
        log(f"  {name}: plan {rec['render']}; K1-K3 per step "
            f"{rec['plan_launches']} as its hops imply; parameters "
            f"bit-identical on all {PODS * POD_DATA} ranks (checksum "
            f"{sums.pop()}), executors built once"
            + (f"; slots per axis {rec['channels']} B"
               if rec["channels"] else ""))
        hops = collections.Counter(
            (r_, tuple(sorted(h.items())))
            for r_, h in zip(rec["bucket_renders"], rec["hops"]))
        log("    hops per bucket per axis: " + "; ".join(
            f"{r_}: {dict(h)} x{n} buckets" for (r_, h), n in hops.items()))
    _same_as(f"smollm-360m {TWO_AXIS_MESH}", by["gloo"], by["cuda_ipc"])
    _same_as(f"smollm-360m {TWO_AXIS_MESH} overlap", by["cuda_ipc"],
             by["cuda_ipc overlap"], "cuda_ipc", "cuda_ipc overlap")
    want = [(b.index, b.strategy, b.leaf_indices) for b in host.buckets]
    require({st for _, st, _ in want} == {"rhd_rsa", COMPOSED},
            f"the axes table's host plan does not mix the flat fold and "
            f"{COMPOSED}: {want}")
    for label in ("auto overlap", "auto post-backward"):
        for rank, rec in enumerate(by[label]):
            require([tuple(b) for b in rec["buckets"]] == want
                    and (rec["fingerprint"] == host.fingerprint())
                    == rec["overlap"],
                    f"rank {rank} {label}: buckets {rec['buckets']} are "
                    f"not the host plan's {want}")
    log(f"  auto: each bucket's schedule, as a host plan() of the same "
        f"tree and table chose it: {host.render()}")
    _same_as(f"smollm-360m {TWO_AXIS_MESH} auto overlap",
             by["auto post-backward"], by["auto overlap"],
             "auto post-backward", "auto overlap")
    cnn = [r["cnn"] for r in results]
    for rank, c in enumerate(cnn):
        for transport, run in c.items():
            require(all(math.isfinite(x) for x in run["losses"]),
                    f"rank {rank} ResNet-50 {COMPOSED} {transport}: "
                    f"non-finite loss")
            require(not any(run["totals"].values()),
                    f"rank {rank} ResNet-50 {COMPOSED} {transport}: the "
                    f"uncoded schedule launched {run['totals']}")
        require(c["gloo"]["checksum"] == c["cuda_ipc"]["checksum"],
                f"rank {rank} ResNet-50 {COMPOSED}: parameters differ "
                f"between gloo ({c['gloo']['checksum']}) and cuda_ipc "
                f"({c['cuda_ipc']['checksum']})")
    sums = {c["cuda_ipc"]["checksum"] for c in cnn}
    require(len(sums) == 1, f"ResNet-50 {COMPOSED}: parameters differ "
                            f"across ranks {sums}")
    c = cnn[0]
    log(f"  ResNet-50 {CNN_IMAGE}x{CNN_IMAGE}, global batch {CNN_BATCH}, "
        f"{COMPOSED} uncoded on mesh {TWO_AXIS_MESH}, deterministic cuDNN, "
        f"{TWO_AXIS_CNN_STEPS} steps: plan {c['cuda_ipc']['render']}; "
        f"parameters bit for bit between gloo and cuda_ipc on every rank "
        f"and across ranks (checksum {sums.pop()}); losses "
        f"{[round(x, 5) for x in c['cuda_ipc']['losses']]}; step_s gloo "
        f"{[round(x, 3) for x in c['gloo']['step_s']]}, cuda_ipc "
        f"{[round(x, 3) for x in c['cuda_ipc']['step_s']]}")
    checks = [r["check"] for r in results]
    log(f"  step 1's gradient, {COMPOSED} + {LEVEL_CODECS} against flat "
        f"rhd_rsa + int8 over the 4 ranks: largest difference "
        f"{max(c['worst_ratio'] for c in checks):.3f} of the bound (both "
        f"schedules' codec.tolerance per level, grown with the partial "
        f"sums: {checks[0]['bound_rel']:.4f} of each bucket's input absmax, "
        f"over 4)")
    log(f"  aggregate of the full gradient tree timed alone on {gpu_line()}:")
    log(f"    step 1's gradient, one spawn, {checks[0]['n_buckets']} buckets "
        f"of 4 hops each way, s per rank: " + "; ".join(
            f"{name} {[round(c['secs'][name], 4) for c in checks]}"
            for name in checks[0]["secs"]))
    log(f"    phase 7 (flat rhd_rsa + int8, cuda_ipc): "
        f"{[round(r['breakdown']['aggregate_s'], 4) for r in phase7['lm']]}")
    for label, recs in by.items():
        log(f"    {label}: aggregate_s "
            f"{[round(r['breakdown']['aggregate_s'], 4) for r in recs]}, "
            f"step_s {[round(s_['step_s'], 4) for s_ in recs[0]['steps']]}; "
            f"{_traffic_line(recs[0]['breakdown'])}")
    return results


# ---------------------------------------------------------------------------
# phase 10: the model axis, data x model
# ---------------------------------------------------------------------------

MA_DATA, MA_MODEL = 2, 2              # the mesh: data 2 x model 2
MODEL_MESH = f"{MA_DATA}x{MA_MODEL}"
# (label, transport, codec), all rhd_rsa over the data axis and K5
# AdamW: the uncoded runs bracket replicated buckets (rhd@data×ag@model);
# int8 skips the bracket, as the reference's planner does.
MODEL_RUNS = (("gloo", "gloo", "none"),
              ("cuda_ipc", "cuda_ipc", "none"),
              ("cuda_ipc int8", "cuda_ipc", "int8"))
# The reference wall's tolerance on parameters held across lowerings,
# read here on what the data-only run's 3 steps changed (p3 - p0)
# against the witness's: the two differ only in the last bit of the
# clip's norm, and under AdamW in bf16 compute that alone moves values
# by up to lr (printed, not required; the model runs are held to the
# witness bit for bit).
MA_RTOL, MA_ATOL = 1e-3, 5e-5
GNORM_ULPS = 4            # a norm of the same gradients, summed in another order


def _model_args(codec, mesh=MODEL_MESH):
    return train_args(full=True, batch=2 * MA_DATA * MA_MODEL, seq=512,
                      device="cuda", strategy="rhd_rsa", codec=codec,
                      mesh=mesh)


def _model_small_args():
    return train_args(full=False, batch=2 * MA_DATA * MA_MODEL, seq=32,
                      steps=2, dtype="float32", strategy="rhd_rsa",
                      codec="none", mesh=MODEL_MESH)


def _block(full, spec, rank, m):
    """Model rank ``rank``'s block of a full leaf (the leaf if
    replicated)."""
    from repro_torch.core import manual
    d = manual.sharded_dim(spec)
    if d is None:
        return full
    n = full.shape[d] // m
    return full.narrow(d, rank * n, n)


def _bits_equal(a, b):
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _model_checksum(tensors):
    import torch
    return sum(int(t.detach().view(torch.int32).to(torch.int64).sum())
               for t in tensors)


def _ulps(a, b):
    """How many float32 steps apart two float32 values are."""
    import numpy as np
    return abs(a - b) / float(np.spacing(np.float32(max(abs(a), abs(b)))))


def _data_only_run(groups, on_grads, norms=None):
    """3 AdamW steps of the data-only run (``rhd_rsa`` on the data group
    alone, 2 ranks, the same global batch) from the seed.  Each step
    calls ``on_grads(reduced, gnorm)`` (the step's ``inspect``).  With
    ``norms`` (one float per step) the witness run: its clip scales by
    those norms in place of its own, whose values it returns.  Returns
    ``(trainer, final leaves, its own norms)``."""
    import torch
    from repro_torch import tree
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim import clip as clip_mod
    args = _model_args("none", mesh=None)
    dp = build_trainer(args, verbose=False, groups={"data": groups["data"]})
    dp.extras["inspect"] = on_grads
    module, opt_state = dp.init_state(args.seed)
    plain_norm, own = clip_mod.global_norm, []

    def fed_norm(grads, sharded=None, model_group=None):
        x = plain_norm(grads)
        own.append(float(x))
        return torch.tensor(norms[len(own) - 1], dtype=x.dtype,
                            device=x.device)

    if norms is not None:
        clip_mod.global_norm = fed_norm
    try:
        module, opt_state, _ = dp.run(args.steps, module, opt_state)
    finally:
        clip_mod.global_norm = plain_norm
    return dp, [t.detach() for t in tree.leaves(module.tree())], own


def model_axis_rank(rank, world, small_args):
    """On the 2 x 2 data x model mesh (``launch.mesh.make_groups``, gloo
    groups first, then cuda_ipc), every run K5 AdamW from one seed: each
    run of :data:`MODEL_RUNS` through ``build_trainer``, with per-step
    launches, the gather boundary's and the bracket's bytes, peak memory
    and the full parameters' checksum, each step's global norm and, on
    uncoded cuda_ipc, step 1's aggregated gradient (the step's
    ``inspect``) and the final shards kept; then the data-only witness
    run (2 ranks per data group, clipped by the model run's norms), held
    to them bit for bit, its own norms beside the model run's; then the
    data-only run as it is, what 3 steps changed against the witness's;
    then a small float32 model on the card and on the host at the same
    mesh."""
    import torch
    from repro_torch import tree
    from repro_torch.core import plan_cache
    from repro_torch.launch.mesh import make_groups
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.common import ParamTree

    device = _model_args("none").device
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    groups = {"gloo": make_groups(1, MA_DATA, MA_MODEL, transport="gloo"),
              "cuda_ipc": make_groups(1, MA_DATA, MA_MODEL)}
    for g in groups.values():
        del g["pod"]
    require(groups["cuda_ipc"]["model"].transport == "cuda_ipc",
            "the mesh's groups are not on cuda_ipc")

    def release():
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()     # closes the channels
        if cuda:
            torch.cuda.empty_cache()

    runs, kept, held = [], {}, 0
    for label, transport, codec in MODEL_RUNS:
        args = _model_args(codec)
        trainer = build_trainer(args, verbose=False, groups=groups[transport])
        keep = label == "cuda_ipc"
        gnorms = []

        def inspect(reduced, gnorm, gnorms=gnorms, keep=keep):
            gnorms.append(float(gnorm))
            if keep and "grad1" not in kept:
                kept["grad1"] = [g.detach().clone()
                                 for g in tree.leaves(reduced)]

        trainer.extras["inspect"] = inspect
        module, opt_state = trainer.init_state(args.seed)
        n_leaves = len(tree.leaves(module.tree()))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps = []
        _reset_counts()                       # main path starts here
        for s in range(args.steps):
            before, cache0 = _counts(), _cache_counts()
            module, opt_state, hist = trainer.run(1, module, opt_state,
                                                  start_step=s)
            after = _counts()
            steps.append({**hist[0], "launches": {k: after[k] - before[k]
                                                  for k in after},
                          **_cache_delta(cache0)})
        totals = _counts()                    # main path ends here
        if keep:       # step 1's gradient, kept from step 1 on
            held += sum(g.numel() * g.element_size() for g in kept["grad1"])
        peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30 \
            if cuda else 0.0
        agg = trainer.extras["aggregator"]
        sched = agg.last_schedule
        ex = plan_cache.GLOBAL_EXECUTOR_CACHE.executor_for(
            sched, agg.groups, args.device)
        full = tree.leaves(trainer.full_params(module.tree()))
        rec = {"label": label, "transport": transport, "codec": codec,
               "steps": steps, "totals": totals, "k5": n_leaves,
               "scalar": _scalar_counts(), "peak_gib": peak_gib,
               "checksum": _checksum(module.tree()),
               "full_checksum": _model_checksum(full), "gnorms": gnorms,
               "render": sched.render(), "bracketed": sched.bracketed,
               "plan_launches": _plan_hop_launches(sched),
               "bracket_bytes": sum(st.wire_bytes for b in sched.buckets
                                    for st in b.stages
                                    if st.axis == "model"),
               "channels": [(ch.group.name, ch.slot_bytes)
                            for ch in ex.channels]}
        if keep:
            kept.update(final=[p.detach().clone()
                               for p in tree.leaves(module.tree())],
                        gnorms=gnorms,
                        specs=tree.leaves(trainer.extras["mspecs"]),
                        m_rank=trainer.extras["model_group"].rank)
            held += sum(p.numel() * p.element_size() for p in kept["final"])
        del opt_state, full
        rec["breakdown"] = _step_breakdown(trainer, module, args.device,
                                           args.steps, rank, world)
        runs.append(rec)
        del trainer, module
        release()

    # The witness: the data-only run clipped by the model run's norms,
    # its gradients and parameters held to the model run's shards.
    specs, m_rank = kept["specs"], kept["m_rank"]

    def blocks_equal(fulls, shards):
        return all(_bits_equal(_block(f, s, m_rank, MA_MODEL), x)
                   for f, x, s in zip(fulls, shards, specs))

    witness = {}

    def on_witness(reduced, gnorm):
        if "grad1_equal" not in witness:
            witness["grad1_equal"] = blocks_equal(tree.leaves(reduced),
                                                  kept.pop("grad1"))

    dp, w_final, w_own = _data_only_run(groups["cuda_ipc"], on_witness,
                                        norms=kept["gnorms"])
    witness.update(
        own_gnorms=w_own, final_equal=blocks_equal(w_final, kept["final"]),
        final_diff=max(float((_block(f, s, m_rank, MA_MODEL) - x).abs().max())
                       for f, x, s in zip(w_final, kept.pop("final"), specs)))
    w_final = [t.clone() for t in w_final]
    del dp
    release()

    # The data-only run as it is: what 3 steps changed against the
    # witness's (the two differ only in the clip norm's last bit).
    d_gnorms = []
    dp, d_final, _ = _data_only_run(
        groups["cuda_ipc"], lambda reduced, gnorm: d_gnorms.append(
            float(gnorm)))
    p0 = tree.leaves(dp.init_state(_model_args("none").seed)[0].tree())
    worst = {"excess": float("-inf"), "diff": 0.0, "outside": 0}
    upd, n_all = 0.0, 0
    with torch.no_grad():
        for w, d, p in zip(w_final, d_final, p0):
            dw, dd = (w - p).float(), (d - p).float()
            diff = (dw - dd).abs()
            excess = diff - (MA_ATOL + MA_RTOL * dd.abs())
            worst["excess"] = max(worst["excess"], float(excess.max()))
            worst["diff"] = max(worst["diff"], float(diff.max()))
            worst["outside"] += int((excess > 0).sum())
            upd += float(dd.abs().sum())
            n_all += dd.numel()
    data_only = {**witness, "plain_gnorms": d_gnorms, **worst,
                 "mean_update": upd / n_all, "n_elements": n_all}
    del dp, d_final, p0, w_final
    release()

    # The small float32 model at the same mesh, on the host's plain
    # versions and on the card, from one initialisation.
    losses = {}
    init = None
    for label, dev in (("cpu", "cpu"), ("card", device)):
        small = build_trainer(argparse.Namespace(**{**vars(small_args),
                                                    "device": dev}),
                              groups=groups["gloo"], verbose=False)
        if init is None:
            init = small.init_state(small_args.seed)[0].tree()
        mod = ParamTree(tree.tree_map(
            lambda t: t.detach().clone().to(dev), init))
        mod, _, hist = small.run(small_args.steps, mod,
                                 small.optimizer.init(mod.tree()))
        losses[label] = [h["loss"] for h in hist]
    return {"rank": rank, "data_only": data_only, "runs": runs,
            "small_losses": losses}


def run_model_axis_phase(phase3):
    """Full-width smollm-360m on the 4 ranks of the card laid out as
    data 2 x model 2, through ``build_trainer`` (``--mesh 2x2``), global
    batch 8, 3 K5 AdamW steps per run, in one spawn.  Uncoded ``rhd_rsa``
    on gloo and on cuda_ipc (bracketed replicated buckets, ``ag@model``),
    bit for bit to each other, gathered parameters equal on all ranks;
    ``rhd_rsa`` + ``int8`` fused hops on cuda_ipc (no bracket): K1-K3 per
    step as the plan's hops imply, K5 once per leaf, K6 as in phase 3.
    Then the data-only witness (2 ranks, clipped by the model run's
    norms): step 1's aggregated gradient and the final parameters bit for
    bit the model run's shards, its own norm of each step within a few
    ulps of the model run's sharded one; and the data-only run as it is,
    what its 3 steps changed read against the witness's (printed).  Then
    the small float32 model, card against host.  Returns each rank's record."""
    from repro_torch.core.dist import run_ranks
    small = _model_small_args()
    world = MA_DATA * MA_MODEL
    log(f"  smollm-360m, seq 512, mesh {MODEL_MESH} (data {MA_DATA} x model "
        f"{MA_MODEL}; {world} ranks on one card), rhd_rsa, K5 AdamW, global "
        f"batch {2 * world} ({2 * world // MA_DATA} rows per data rank, the "
        f"same on each model rank), {TRAIN_STEPS} steps per run: "
        f"{[label for label, *_ in MODEL_RUNS]}, then two data-only runs on "
        f"{MA_DATA} ranks of each data group (the witness, clipped by the "
        f"cuda_ipc run's norms, then as it is)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(model_axis_rank, world, (small,),
                            backend="cuda_ipc", rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1) // world),
                            timeout_s=600)
    log(f"  {world} ranks done in {time.perf_counter() - t0:.1f} s")
    by = {label: [r["runs"][i] for r in results]
          for i, (label, *_) in enumerate(MODEL_RUNS)}
    phase3_lm = {k: phase3[0]["steps"][0]["launches"][k]
                 for k in ("fused_rmsnorm",)}
    for label, recs in by.items():
        name = f"smollm-360m {MODEL_MESH} {label}"
        for rank, rec in enumerate(recs):
            require(rec["label"] == label,
                    "ranks ran the configurations in different orders")
            _require_cached(rank, name, rec["steps"])
            require(rec["bracketed"] == (rec["codec"] == "none"),
                    f"rank {rank} {name}: bracketed {rec['bracketed']} "
                    f"with codec {rec['codec']}")
            require(("ag@model" in rec["render"]) == rec["bracketed"],
                    f"rank {rank} {name}: plan {rec['render']}")
            if rec["transport"] == "cuda_ipc":
                _require_on_card(rec["breakdown"], f"rank {rank} {name}")
                gt = rec["breakdown"]["gather_traffic"]
                require(gt["staged_bytes"] == 0 and gt["mapped_bytes"] > 0,
                        f"rank {rank} {name}: the gather boundary staged "
                        f"through the host: {gt}")
                axes = sorted(ax for ax, _ in rec["channels"])
                require(axes == (["data", "model"] if rec["bracketed"]
                                 else ["data"]),
                        f"rank {rank} {name}: channels {rec['channels']}")
            require(all(math.isfinite(s_["loss"]) for s_ in rec["steps"]),
                    f"rank {rank} {name}: non-finite loss")
            want = {**rec["plan_launches"], "adamw_update": rec["k5"],
                    **phase3_lm}
            for s_, step in enumerate(rec["steps"], 1):
                got = {k: step["launches"][k] for k in want}
                require(got == want, f"rank {rank} {name} step {s_}: "
                                     f"launched {got}, expected {want}")
        sums = {rec["full_checksum"] for rec in recs}
        require(len(sums) == 1, f"{name}: gathered parameters differ "
                                f"across ranks {sums}")
        for rank in range(MA_MODEL, len(recs)):
            require(recs[rank]["checksum"]
                    == recs[rank % MA_MODEL]["checksum"],
                    f"{name}: rank {rank}'s shards differ from its model "
                    f"rank's on the other data rank")
        rec = recs[0]
        for s_, step in enumerate(rec["steps"], 1):
            log(f"  {name} step {s_}: loss {step['loss']:.5f} grad_norm "
                f"{step['grad_norm']:.5f} step_s {step['step_s']:.3f} "
                f"buckets {step['n_buckets']} launches/rank "
                f"{step['launches']}")
        bd = rec["breakdown"]
        log(f"  {name}: plan {rec['render']}; gathered parameters "
            f"bit-identical on all {len(recs)} ranks (checksum "
            f"{sums.pop()}); K1-K3 per step {rec['plan_launches']}, K5 "
            f"{rec['k5']}, K6 {phase3_lm['fused_rmsnorm']}"
            + (f"; slots per axis {rec['channels']} B"
               if rec["channels"] else ""))
        log(f"    model group's all-gather per step and rank: gather "
            f"boundary {bd['gather_traffic']['staged_bytes'] or bd['gather_traffic']['mapped_bytes']} B "
            f"({'staged' if rec['transport'] == 'gloo' else 'written through mappings'}, "
            f"{bd['gather_s']:.4f} s), the plan's ag@model "
            f"{rec['bracket_bytes']} B; peak GiB per rank "
            f"{[round(r['peak_gib'], 2) for r in recs]} (phase 3, full "
            f"replicas, 4 ranks: "
            f"{[round(r['peak_gib'], 2) for r in phase3]})")
        log(f"    layers timed alone: fwd_bwd_s "
            f"{[round(r['breakdown']['fwd_bwd_s'], 4) for r in recs]}, "
            f"aggregate_s "
            f"{[round(r['breakdown']['aggregate_s'], 4) for r in recs]}, "
            f"optimizer_s "
            f"{[round(r['breakdown']['optimizer_s'], 4) for r in recs]}; "
            f"{_traffic_line(bd)}")
    _same_as(f"smollm-360m {MODEL_MESH}", by["gloo"], by["cuda_ipc"])

    # The data-only runs against the uncoded cuda_ipc run.
    for rank, res in enumerate(results):
        do, model = res["data_only"], by["cuda_ipc"][rank]
        require(by["gloo"][rank]["gnorms"] == model["gnorms"],
                f"rank {rank}: grad_norm per step on gloo "
                f"{by['gloo'][rank]['gnorms']}, on cuda_ipc "
                f"{model['gnorms']}")
        require(do["grad1_equal"], f"rank {rank}: step 1's aggregated "
                f"gradient differs from the data-only run's")
        require(do["final_equal"], f"rank {rank}: parameters after "
                f"{TRAIN_STEPS} steps differ from the witness's (max "
                f"|difference| {do['final_diff']:.3e})")
        ulps = [_ulps(a, b) for a, b in zip(do["own_gnorms"],
                                           model["gnorms"])]
        log(f"  rank {rank}: step 1's aggregated gradient and the "
            f"parameters after {TRAIN_STEPS} steps bit for bit the "
            f"witness's; grad_norm per step, sharded {model['gnorms']}, "
            f"the witness's own {do['own_gnorms']} ({ulps} ulps apart), the "
            f"data-only run's {do['plain_gnorms']}")
        require(max(ulps) <= GNORM_ULPS,
                f"rank {rank}: the sharded norm {max(ulps):.0f} ulps from "
                f"the norm of the same gradients")
        log(f"    the data-only run as it is, p3 - p0 against the "
            f"witness's: mean |p3 - p0| {do['mean_update']:.3e} over "
            f"{do['n_elements']} values; {do['outside']} values outside "
            f"rtol {MA_RTOL} / atol {MA_ATOL}, worst excess "
            f"{do['excess']:.3e}, largest |difference| {do['diff']:.3e}")
    sl = results[0]["small_losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(sl["cpu"], sl["card"]))
    log(f"  small float32 model at mesh {MODEL_MESH}, card vs host plain "
        f"versions: losses {sl['card']} vs {sl['cpu']} (max rel {rel:.2e})")
    require(rel <= 1e-3, "card and host training disagree")
    return results


# ---------------------------------------------------------------------------
# phase 11: telemetry on the training path
# ---------------------------------------------------------------------------

LM_LAUNCHES = ("hop_absmax", "hop_encode", "hop_decode_add", "adamw_update",
               "fused_rmsnorm")
CLOSURE_REPS = 3
OVERLAP_LINT_STEPS = 2        # (e): phase 8's overlapped smollm, linted


def _bucket_split(span):
    """Host seconds of a bucket span in its hop spans, in its stage
    spans outside their hops, and in the rest of the bucket (flatten,
    cast, scale)."""
    stages = [c for c in span.children if c.name.startswith("stage[")]
    hops = sum(h.duration_s for st in stages for h in st.children
               if h.name.startswith("hop["))
    in_stages = sum(st.duration_s for st in stages)
    return hops, in_stages - hops, span.duration_s - in_stages


def _hop_issue(span):
    """A bucket span's host seconds in its hop spans: on the card all of
    it is issue (the copy into the slot, the waits and writes enqueued,
    the consumer's kernels); a hop never waits for a peer on the host."""
    from repro_torch.telemetry.trace import walk
    return sum(h.duration_s for h in walk([span])
               if h.name.startswith("hop["))


def _device_clock(rec):
    """The card's clock of an overlapped step (``OverlapRecord``): the
    backward on its stream, each bucket's work from its start to its end
    on the channel's stream (its waits for the peers included), the
    buckets that ended before the backward's last kernel did, and the
    device overlap fraction (``overlap.measured_timeline``)."""
    tl = rec.device_timeline()
    return {"device_backward_s": rec.device_backward_s,
            "device_buckets": [(t.index, t.device_start_s, t.device_end_s)
                               for t in rec.buckets],
            "device_witness": rec.device_witness(),
            "device_overlap": None if tl is None else tl.overlap_fraction}


def _log_hop_split(results, prefix):
    """Phase 11(b) per rank and step.  Host clock: the hops' issue time
    over the step's buckets (no host wait in a hop on the card), the
    host's one wait for the channel (its sync at the backward's join),
    the backward, when it began after the first rank's (the ranks share
    the host's monotonic clock), when the first bucket in channel order
    was issued and HL002's witness.  Card clock: the backward, the channel's work from its first
    bucket's start to its last one's end, when the first bucket ended,
    the buckets that ended before the backward's last kernel, and the
    device overlap fraction."""
    first = [min(r["cnn"]["steps"][i]["t0"] for r in results)
             for i in range(len(results[0]["cnn"]["steps"]))]
    for r in results:
        for s_, step in enumerate(r["cnn"]["steps"], 1):
            issue = step["hop_issue"]
            dev = step["device_buckets"]
            card = "not recorded (off the card)" if step[
                "device_backward_s"] is None else (
                f"backward {_ms(step['device_backward_s'])} ms, the buckets' "
                f"work {_ms(dev[-1][2] - dev[0][1])} ms, first bucket ended "
                f"at {_ms(dev[0][2])} ms, {step['device_witness']} of "
                f"{len(dev)} buckets ended before the backward's last "
                f"kernel, device overlap fraction "
                f"{step['device_overlap']:.4f}")
            log(f"{prefix} rank {r['rank']} step {s_}: host: hops of "
                f"{len(issue)} buckets issued in {_ms(sum(issue))} ms, "
                f"the join's wait {_ms(step['join_wait_s'])} ms; backward "
                f"{_ms(step['backward_s'])} ms, begun "
                f"{_ms(step['t0'] - first[s_ - 1])} ms after the first "
                f"rank's, first bucket issued by "
                f"{_ms(step['buckets'][0][3])} ms; HL002 witness "
                f"{step['lint']['witness']}; card: {card}")


def _stage_bytes(sched, log):
    """``[(stage path, the IR's bytes, the bytes its hops send when
    nothing is padded (``hop_lint.exact_sent_bytes``), the bytes its
    hops sent)]``."""
    from repro_torch.analysis import hop_lint
    sent = hop_lint.stage_sent_bytes(log)
    return [(path, st.hlo_bytes, hop_lint.exact_sent_bytes(st),
             sent.get(path, 0))
            for path, _b, st in sched.iter_stages() if st.hlo_kind]


def _lint(sched, log, backward_end=None, hl002=True):
    """The hop lint of one step: its errors, its warnings the baseline
    does not accept, and (overlapped) the buckets whose hops all ended
    before the backward did, of those with hops; HL002 (at least one)
    is checked unless ``hl002`` is False."""
    from repro_torch.analysis import hop_lint
    diags = hop_lint.lint_hops(sched, log, backward_end=backward_end
                               if hl002 else None)
    return {"errors": [d.render() for d in diags if d.severity == "error"],
            "warnings": [d.render() for d in hop_lint.unbaselined_warnings(
                diags, hop_lint.load_baseline())],
            "witness": None if backward_end is None
            else hop_lint.overlap_witness(log, backward_end)}


def _lm_step_spans(roots, sched, rank):
    """Check one step's spans against the executed schedule: one
    ``trace`` span per stage with the IR's wire bytes and algorithm, one
    per bucket, as many hop spans per stage as ``stage_hops`` counts;
    then the hop lint of its hop log (``analysis/hop_lint.py``: the bytes
    each stage's hops sent, as the transport recorded them, against the
    IR).  Returns the problems found, the lint, each stage's bytes, the
    bytes the hops sent through the mappings (every ppermute and
    all-gather inside the aggregate), and the step's host seconds in hop
    spans, in stage spans outside hops and in bucket spans outside
    stages."""
    from repro_torch.analysis import hop_lint
    from repro_torch.telemetry.trace import walk
    by_path = collections.defaultdict(list)
    for s in walk(roots):
        if s.cat == "trace" and s.attrs.get("ir_path"):
            by_path[s.attrs["ir_path"]].append(s)
    problems = []
    for path, _bucket, st in sched.iter_stages():
        got = by_path.get(path, [])
        if len(got) != 1:
            problems.append(f"{path}: {len(got)} spans")
            continue
        sp = got[0]
        if (sp.attrs["wire_bytes"], sp.attrs["algorithm"]) \
                != (st.wire_bytes, st.algorithm):
            problems.append(f"{path}: span {sp.attrs}, stage {st}")
        hops = [c for c in sp.children if c.name.startswith("hop[")]
        acc, fwd, _ = hop_lint.stage_hops(st)
        if len(hops) != acc + fwd:
            problems.append(f"{path}: {len(hops)} hop spans, the plan's "
                            f"hops {acc + fwd}")
    buckets = [s for b in sched.buckets for s in by_path.get(b.path, [])]
    if len(buckets) != len(sched.buckets):
        problems.append(f"{len(buckets)} bucket spans for "
                        f"{len(sched.buckets)} buckets")
    split = [sum(x) for x in zip(*map(_bucket_split, buckets))] \
        if buckets else [0.0, 0.0, 0.0]

    def total(name):
        return sum(s.duration_s for s in walk(roots) if s.name == name)

    log = hop_lint.hop_log(roots, rank=rank)
    mapped = sum(r["sent_bytes"] for r in log if r["aggregate"]
                 and r["kind"] in ("collective-permute", "all-gather"))
    return {"problems": problems, "lint": _lint(sched, log),
            "stage_bytes": _stage_bytes(sched, log),
            "span_mapped_bytes": mapped,
            "hop_s": split[0], "stage_s": split[1], "bucket_s": split[2],
            "aggregate_s": total("aggregate"),
            "train_step_s": total("train.step")}


IPC_CHECK_N = CHECK_N        # (f): a main-path bucket (1 Mi f32)
IPC_CHECK_HOPS = 5           # (f): ring hops back to back, past SLOTS
PINGPONG_BYTES = 4096        # (f): the timed hop
PINGPONG_HOPS = 100


def _ipc_check(rank, world, device):
    """(f): the cuda_ipc channel's waits on the card (``csrc/mailbox.cu``'s
    ``ipc_wait``) against gloo in the same ranks: ring hops of mixed sizes
    back to back (more than ``dist.SLOTS``), an all-gather, and
    ``rhd_rsa`` and ``ring_rsa`` of a 1 Mi-element f32 bucket, each
    through a channel of its own and each bit for bit gloo's; every
    channel must have enqueued waits on the card.  Then one hop's time:
    ``PINGPONG_HOPS`` ring hops of 4 KiB on the card's clock through a
    channel, and through gloo (host-staged: host clock, synchronised)."""
    import torch
    from repro_torch.core import Group, reducers
    from repro_torch.core import dist as core_dist
    gen = torch.Generator(device=device).manual_seed(rank)
    x = torch.randn(IPC_CHECK_N, generator=gen, device=device)
    ring = [(i, (i + 1) % world) for i in range(world)]
    cases = {
        "ring hops": lambda g: [
            core_dist.ppermute(x[:1 + (7919 * i) % IPC_CHECK_N] + i, g, ring)
            for i in range(IPC_CHECK_HOPS)],
        "all_gather": lambda g: [core_dist.all_gather(x[:4096], g)],
        "rhd_rsa": lambda g: [reducers.allreduce(x, [g], "rhd_rsa")],
        "ring_rsa": lambda g: [reducers.allreduce(x, [g], "ring_rsa")]}
    gloo, ipc = Group(transport="gloo"), Group()
    out = {"bits": {}, "waits": {}, "max_abs": 0.0}
    for name, fn in cases.items():
        want = fn(gloo)
        with core_dist.IpcChannel(ipc, 4 * IPC_CHECK_N, device) as ch:
            got = fn(ch.group)
            ch.sync()
            out["waits"][name] = ch.waits
        out["bits"][name] = all(bits_equal(a, b) for a, b in zip(got, want))
        out["max_abs"] = max([out["max_abs"]]
                             + [max_abs(a, b) for a, b in zip(got, want)])
    y = x[:PINGPONG_BYTES // 4]
    with core_dist.IpcChannel(ipc, PINGPONG_BYTES, device) as ch:
        for _ in range(10):
            core_dist.ppermute(y, ch.group, ring)
        ch.sync()
        torch.distributed.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PINGPONG_HOPS):
            core_dist.ppermute(y, ch.group, ring)
        end.record()
        ch.sync()
        out["ms"] = start.elapsed_time(end) / PINGPONG_HOPS
    for _ in range(10):
        core_dist.ppermute(y, gloo, ring)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(PINGPONG_HOPS):
        core_dist.ppermute(y, gloo, ring)
    torch.cuda.synchronize()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3 / PINGPONG_HOPS
    return out


def telemetry_rank(rank, world, args, trace_path):
    """Phase 11 on one rank, ``REPRO_TRACE`` set: (a) phase 7's
    smollm-360m on cuda_ipc, its spans checked and its hops linted per
    step; (c) the closure on its executed schedule; (b) phase 8's
    overlapped ResNet-50, its channel's spans split per bucket and its
    hops linted with HL002; (e) phase 8's overlapped smollm-360m, linted
    (HL002's witness printed, not required); (d) rank 0 writes the trace
    to ``trace_path`` and reloads it."""
    import torch
    from repro_torch import telemetry
    from repro_torch.analysis import hop_lint
    from repro_torch.core import Group, overlap, plan_cache
    from repro_torch.core import dist as core_dist
    from repro_torch.launch.train import build_trainer
    from repro_torch.telemetry import closure, trace

    tracer = telemetry.get_tracer()
    require(tracer.enabled, "REPRO_TRACE did not turn telemetry on in the "
                            "ranks")
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    group = Group()

    # (a) smollm-360m, seq 512, rhd_rsa + int8, K5 AdamW: phase 7's run.
    trainer = build_trainer(args, verbose=False, groups={"data": group})
    agg = trainer.extras["aggregator"]
    module, opt_state = trainer.init_state(args.seed)
    telemetry.METRICS.reset()
    steps = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()                           # main path starts here
    waits0 = core_dist.traffic["device_waits"]
    for s in range(args.steps):
        n0 = len(tracer.roots)
        before, cache0 = _counts(), _cache_counts()
        traffic0 = dict(core_dist.traffic)
        module, opt_state, hist = trainer.run(1, module, opt_state,
                                              start_step=s)
        after = _counts()
        traffic = {k: core_dist.traffic[k] - traffic0[k] for k in traffic0}
        steps.append({**hist[0], "traffic": traffic,
                      "launches": {k: after[k] - before[k] for k in after},
                      **_cache_delta(cache0),
                      **_lm_step_spans(tracer.roots[n0:],
                                       agg.last_schedule, rank)})
    totals = _counts()                        # main path ends here
    waits = core_dist.traffic["device_waits"] - waits0
    sched = agg.last_schedule
    hist = telemetry.METRICS.snapshot()["metrics"]["train_step_s"]
    lm = {"steps": steps, "totals": totals, "scalar": _scalar_counts(),
          "device_waits": waits,
          "checksum": _checksum(module.tree()),
          "train_step_samples": hist["values"][""]["count"],
          "render": sched.render(), "n_buckets": sched.n_buckets,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
          if cuda else 0.0}
    del trainer, module, opt_state

    # (c) the closure on (a)'s executed schedule: each distinct stage
    # replayed alone, then the fused route against the unfused one.
    t0 = time.perf_counter()
    measured = closure.measure_schedule(sched, agg.groups,
                                        reps=CLOSURE_REPS,
                                        device=args.device)
    report = closure.closure_report(sched, measured)
    k = report["calibration"]["k"]
    last = steps[-1]
    compute_host = last["train_step_s"] - last["aggregate_s"]
    timelines = None
    if k > 0 and math.isfinite(k):
        compute = compute_host / k               # in the model's units
        timelines = {
            "measured": closure.measured_timeline(
                sched, measured, k, compute).to_dict(),
            "predicted": overlap.simulate_schedule(sched, compute).to_dict()}
    fused = closure.measure_fused_replay(sched, agg.groups,
                                         reps=CLOSURE_REPS,
                                         device=args.device)
    fused.pop("executor_stats")
    closure_rec = {"paths": [p for p, _b, _s in sched.iter_stages()],
                   "measured": measured,
                   "calibration": report["calibration"],
                   "max_ratio": report["max_ratio"],
                   "all_within_band": report["all_within_band"],
                   "n_gated": report["n_gated"], "band": report["band"],
                   "compute_host_s": compute_host, "timelines": timelines,
                   "fused": fused, "seconds": time.perf_counter() - t0}
    plan_cache.GLOBAL_EXECUTOR_CACHE.clear()     # closes the channels
    if cuda:
        torch.cuda.empty_cache()

    # (b) ResNet-50 rhd_rsa, overlap=True, deterministic cuDNN: phase 8's
    # run, its buckets reduced on the channel's thread.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    trainer = cnn_trainer("resnet50", "rhd_rsa", CNN_IMAGE, CNN_BATCH,
                          "bfloat16", args.device,
                          Group(transport="cuda_ipc"),
                          data_device=args.device, overlap=True)
    cnn_agg = trainer.extras["aggregator"]
    module, opt_state = trainer.init_state(0)
    cnn_steps = []
    _reset_counts()                           # main path starts here
    waits0 = core_dist.traffic["device_waits"]
    for s in range(CNN_WARMUP + CNN_TIMED):
        n0 = len(tracer.roots)
        before, cache0 = _counts(), _cache_counts()
        module, opt_state, hist = trainer.run(1, module, opt_state,
                                              start_step=s)
        after = _counts()
        roots = tracer.roots[n0:]
        rec = cnn_agg.last_overlap
        spans = {b.attrs["ir_path"]: b for b in roots
                 if b.name.startswith("bucket[")}
        bsched = cnn_agg.last_schedule
        off_track = [s_.name for b in spans.values() for s_ in trace.walk([b])
                     if s_.attrs.get("thread") != "overlap-channel"]
        hops = hop_lint.hop_log(roots, rank=rank)
        cnn_steps.append({
            "lint": _lint(bsched, hops, rec.backward_end),
            "stage_bytes": _stage_bytes(bsched, hops),
            **hist[0], "launches": {k_: after[k_] - before[k_]
                                    for k_ in after},
            **_cache_delta(cache0),
            "bucket_paths": sorted(spans),
            "want_paths": sorted(b.path for b in bsched.buckets),
            "off_track": off_track,
            "backward_s": rec.backward_s,
            "t0": rec.t0,
            "buckets": [(t.index, t.ready_s, t.start_s, t.end_s,
                         *_bucket_split(spans[f"bucket[{t.index}]"]))
                        for t in rec.buckets
                        if f"bucket[{t.index}]" in spans],
            "hop_issue": [_hop_issue(spans[f"bucket[{t.index}]"])
                          for t in rec.buckets
                          if f"bucket[{t.index}]" in spans],
            "join_wait_s": sum(s_.duration_s for s_ in trace.walk(roots)
                               if s_.name == "cuda_ipc.sync"),
            **_device_clock(rec)})
    cnn = {"steps": cnn_steps, "totals": _counts(),
           "device_waits": core_dist.traffic["device_waits"] - waits0,
           "scalar": _scalar_counts(),
           "checksum": _checksum(module.tree())}
    del trainer, module, opt_state
    plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
    if cuda:
        torch.cuda.empty_cache()

    # (e) smollm-360m overlapped (phase 8's run), linted: its stacked
    # leaves and tied embedding complete only at the end of backward, so
    # HL002's witness is printed, not required.
    trainer = build_trainer(args, verbose=False, groups={"data": group},
                            aggregator=_overlap_config(args, True, None))
    ov_agg = trainer.extras["aggregator"]
    module, opt_state = trainer.init_state(args.seed)
    ov_steps = []
    _reset_counts()                           # main path starts here
    waits0 = core_dist.traffic["device_waits"]
    for s in range(OVERLAP_LINT_STEPS):
        n0 = len(tracer.roots)
        module, opt_state, hist = trainer.run(1, module, opt_state,
                                              start_step=s)
        hops = hop_lint.hop_log(tracer.roots[n0:], rank=rank)
        ov_steps.append({**hist[0], "lint": _lint(
            ov_agg.last_schedule, hops, ov_agg.last_overlap.backward_end,
            hl002=False),
            "stage_bytes": _stage_bytes(ov_agg.last_schedule, hops)})
    lm_overlap = {"steps": ov_steps, "totals": _counts(),
                  "device_waits": core_dist.traffic["device_waits"] - waits0,
                  "scalar": _scalar_counts()}
    del trainer, module, opt_state
    plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
    if cuda:
        torch.cuda.empty_cache()

    # (d) the trace file: rank 0's, reloaded.
    trace_rec = None
    if rank == 0:
        tracer.write(trace_path)
        with open(trace_path) as f:
            doc = json.load(f)
        forest = trace.from_json(doc["repro"])
        trace_rec = {"events": len(doc["traceEvents"]),
                     "bytes": os.path.getsize(trace_path),
                     "roots": len(forest),
                     "spans": sum(1 for _ in trace.walk(forest)),
                     "tids": sorted({e["tid"] for e in doc["traceEvents"]})}
    # (f) the channel's waits on the card against gloo, and a hop's time.
    ipc_check = _ipc_check(rank, world, args.device) if cuda else None
    return {"rank": rank, "lm": lm, "closure": closure_rec, "cnn": cnn,
            "lm_overlap": lm_overlap, "trace": trace_rec,
            "ipc_check": ipc_check}


def _ms(seconds):
    return round(seconds * 1e3, 3)


def _stage_bytes_lines(stage_bytes):
    """Each distinct (IR bytes, bytes sent) of a step's stages, with how
    many stages had it."""
    counts = collections.Counter((ir, sent)
                                 for _p, ir, _exact, sent in stage_bytes)
    return "; ".join(f"IR {ir} B, sent {sent} B ({sent / ir:.4f}) x{n}"
                     for (ir, sent), n in sorted(counts.items()))


def _require_lint(rank, label, steps):
    for s_, step in enumerate(steps, 1):
        lint = step["lint"]
        require(not lint["errors"] and not lint["warnings"],
                f"rank {rank} {label} step {s_}: the hop lint found "
                f"{lint['errors'][:3]} {lint['warnings'][:3]}")


def run_telemetry_phase(phase7, phase8):
    """Phase 11: one 4-rank cuda_ipc spawn with ``REPRO_TRACE`` set in
    the ranks.  (a) phase 7's smollm-360m (seq 512, rhd_rsa + int8 fused
    hops, K5 AdamW, 3 steps): parameters and K1/K2/K3/K5/K6 launches per
    step equal phase 7's telemetry-off run; every stage and bucket path
    of the executed schedule has one span per step with the IR's wire
    bytes and algorithm, as many hop spans as the plan's hops; the hop
    lint (phase 15(b)) finds no error and no unbaselined warning, and the
    bytes the hops sent account for the bytes written through the
    mappings; ``train_step_s`` has 3 samples.  (b) phase 8's overlapped
    ResNet-50: parameters equal phase 8's, every bucket's spans on the
    channel's track, the hop lint clean with HL002 checked.  (c) the
    closure on (a)'s schedule: every path measured, k finite and
    positive.  (e) phase 8's overlapped smollm-360m, 2 steps: the lint
    clean, HL002's witness printed.  (d) rank 0's trace file reloads.
    With ``phase7``/``phase8`` None (``--analysis-only``) the runs are
    not held to theirs, and (a) requires every main-path kernel to
    launch.  Returns each rank's record."""
    from repro_torch.core.dist import run_ranks
    from repro_torch.telemetry import trace
    args = train_args(full=True, batch=2 * TRAIN_WORLD, seq=512,
                      device="cuda")
    log(f"  {TRAIN_WORLD} ranks on cuda_ipc, {trace.ENV_VAR}=1 in the "
        f"ranks: (a) smollm-360m seq 512 {args.strategy} + {args.codec}, "
        f"{args.steps} steps (phase 7's run); (c) the closure on its "
        f"schedule, {CLOSURE_REPS} reps; (b) ResNet-50 rhd_rsa overlap=True, "
        f"{CNN_WARMUP} + {CNN_TIMED} steps (phase 8's run); (e) smollm-360m "
        f"overlap=True, {OVERLAP_LINT_STEPS} steps; (d) rank 0's trace file; "
        f"every step's hops linted")
    t0 = time.perf_counter()
    os.environ[trace.ENV_VAR] = "1"
    try:
        with tempfile.TemporaryDirectory() as rdv:
            results = run_ranks(
                telemetry_rank, TRAIN_WORLD,
                (args, os.path.join(rdv, "trace.json")), backend="cuda_ipc",
                rendezvous_dir=rdv,
                threads=max(1, (os.cpu_count() or 1) // TRAIN_WORLD),
                timeout_s=600)
    finally:
        del os.environ[trace.ENV_VAR]
    seconds = time.perf_counter() - t0
    log(f"  {TRAIN_WORLD} ranks done in {seconds:.1f} s")

    # (a)
    base7 = phase7["lm"] if phase7 else [None] * len(results)
    for r, base in zip(results, base7):
        lm, rank = r["lm"], r["rank"]
        _require_cached(rank, "phase 11 smollm-360m", lm["steps"])
        _require_cached(rank, "phase 11 ResNet-50", r["cnn"]["steps"])
        _require_lint(rank, "smollm-360m", lm["steps"])
        if base is not None:
            require(lm["checksum"] == base["checksum"],
                    f"rank {rank}: traced smollm parameters "
                    f"{lm['checksum']} differ from phase 7's "
                    f"{base['checksum']}")
        for s_, step in enumerate(lm["steps"], 1):
            got = {k: step["launches"][k] for k in LM_LAUNCHES}
            if base is not None:
                want = {k: base["steps"][s_ - 1]["launches"][k]
                        for k in LM_LAUNCHES}
                require(got == want, f"rank {rank} step {s_}: traced "
                                     f"launches {got}, phase 7's {want}")
            else:
                require(all(got.values()), f"rank {rank} step {s_}: "
                                           f"launches {got}")
            require(not step["problems"], f"rank {rank} step {s_}: spans "
                                          f"{step['problems'][:5]}")
            # Every stage's hops sent exactly what the IR charges, with
            # one scale per encoded block in place of one per hop
            # (smollm's payloads split evenly over 4 ranks): a payload
            # sent twice, padded or cut short misses by a byte or more.
            off = [(p, exact, sent) for p, _ir, exact, sent
                   in step["stage_bytes"] if sent != exact]
            require(not off, f"rank {rank} step {s_}: (stage, bytes the "
                             f"IR gives, bytes the hops sent) {off[:5]}")
            # The step's staged bytes are the metrics' psum (gloo), not
            # the aggregate's.
            mapped = step["traffic"]["mapped_bytes"]
            require(step["span_mapped_bytes"] == mapped,
                    f"rank {rank} step {s_}: the hops sent "
                    f"{step['span_mapped_bytes']} B, the transport wrote "
                    f"{mapped} B ({step['traffic']})")
            require(math.isfinite(step["loss"]), "non-finite loss")
        require(lm["train_step_samples"] == TRAIN_STEPS,
                f"rank {rank}: train_step_s has {lm['train_step_samples']} "
                f"samples")
    lm0 = results[0]["lm"]
    held = "bit for bit phase 7's" if phase7 else "not held (phase 7 not run)"
    log(f"  (a) plan {lm0['render']}; parameters {held} on every rank "
        f"(checksum {lm0['checksum']}); K1/K2/K3/K5/K6 per step "
        f"{[lm0['steps'][0]['launches'][k] for k in LM_LAUNCHES]}; every "
        f"stage and bucket path one span per step; hop spans per stage as "
        f"the plan's hops; the hop lint clean on every rank and step; "
        f"each stage's hops sent exactly the IR's bytes with a scale per "
        f"encoded block; the bytes the hops sent = bytes written through "
        f"the mappings "
        f"({lm0['steps'][0]['span_mapped_bytes']} B a step on rank 0); "
        f"train_step_s {TRAIN_STEPS} samples; peak allocated per rank "
        f"{[round(r['lm']['peak_gib'], 2) for r in results]} GiB")
    log(f"    rank 0 step 1, per stage (phase 15(b)): "
        f"{_stage_bytes_lines(lm0['steps'][0]['stage_bytes'])}")
    for r, base in zip(results, base7):
        log(f"    rank {r['rank']} host ms per step: "
            + "; ".join(
                f"step {i} train.step {_ms(st['train_step_s'])}"
                + (f" (phase 7 step_s {_ms(b['step_s'])})" if b else "")
                + f", aggregate {_ms(st['aggregate_s'])} = hops "
                f"{_ms(st['hop_s'])} + stages outside hops "
                f"{_ms(st['stage_s'])} + buckets outside stages "
                f"{_ms(st['bucket_s'])} + the rest"
                for i, (st, b) in enumerate(
                    zip(r["lm"]["steps"], base["steps"] if base
                        else [None] * len(r["lm"]["steps"])), 1)))

    # (c)
    for r in results:
        c = r["closure"]
        require(list(c["measured"]) == c["paths"]
                and all(math.isfinite(v) and v > 0
                        for p, v in c["measured"].items()),
                f"rank {r['rank']}: the closure measured {c['measured']} "
                f"for paths {c['paths']}")
        k = c["calibration"]["k"]
        require(math.isfinite(k) and k > 0, f"rank {r['rank']}: k = {k}")
    c = results[0]["closure"]
    per = {p: round(v["k"], 4) for p, v in
           c["calibration"]["per_axis_size"].items()}
    tl = c["timelines"]
    log(f"  (c) closure on (a)'s schedule ({len(c['paths'])} stages, "
        f"{c['seconds']:.1f} s): measured ms per path "
        f"{ {p: _ms(v) for p, v in c['measured'].items()} }; k "
        f"{c['calibration']['k']:.4f} (per axis size {per}), max_ratio "
        f"{c['max_ratio']:.4f} over {c['n_gated']} gated stages, "
        f"all_within_band {c['all_within_band']} (band x"
        f"{c['band']['factor']} declared for host-CPU replays: read, not "
        f"required); compute {c['compute_host_s']:.4f} s host: overlap "
        f"fraction measured {tl['measured']['overlap_fraction']:.4f}, "
        f"predicted {tl['predicted']['overlap_fraction']:.4f}")
    f = c["fused"]
    log(f"    fused replay (GDR-Opt's fused hop, K1-K3) against the unfused "
        f"route: fused {f['fused_s'] * 1e3:.3f} ms, unfused "
        f"{f['unfused_s'] * 1e3:.3f} ms, speedup {f['speedup']:.3f}, "
        f"residual {f['residual_rel']:.3e}, executor traces "
        f"{f['executor_traces']}")

    # (b)
    _log_hop_split(results, "  (b) hop split:")
    base8 = {r["rank"]: r["runs"][0] for r in phase8["cnn"]} \
        if phase8 else {}
    for r in results:
        cnn, rank = r["cnn"], r["rank"]
        if phase8:
            require(cnn["checksum"] == base8[rank]["checksum"],
                    f"rank {rank}: traced ResNet-50 parameters "
                    f"{cnn['checksum']} differ from phase 8's "
                    f"{base8[rank]['checksum']}")
        _require_lint(rank, "ResNet-50 overlapped", cnn["steps"])
        for s_, step in enumerate(cnn["steps"], 1):
            require(step["bucket_paths"] == step["want_paths"]
                    and len(step["buckets"]) == len(step["want_paths"]),
                    f"rank {rank} step {s_}: bucket spans "
                    f"{step['bucket_paths']}")
            require(not step["off_track"],
                    f"rank {rank} step {s_}: spans off the channel's "
                    f"track {step['off_track'][:5]}")
    witness = [step["lint"]["witness"] for r in results
               for step in r["cnn"]["steps"]]
    log(f"  (b) ResNet-50 overlapped: parameters "
        f"{'bit for bit phase 8' if phase8 else 'not held (phase 8 not run)'}"
        f"'s on every rank; every bucket's spans on the overlap-channel "
        f"track; the hop lint clean on every rank and step with HL002: "
        f"buckets whose hops all ended before the backward did, of those "
        f"with hops, per rank and step {witness}")
    log(f"    rank 0 last step, per stage: "
        f"{_stage_bytes_lines(results[0]['cnn']['steps'][-1]['stage_bytes'])}")
    last = results[0]["cnn"]["steps"][-1]
    log(f"    rank 0, last step, channel order, ms from the start of "
        f"backward (backward {_ms(last['backward_s'])}): bucket ready "
        f"start end | channel span split: hops, stages outside hops, "
        f"rest (flatten, cast, scale)")
    for index, ready, start, end, hop, stage, rest in last["buckets"]:
        log(f"      bucket {index:3d} {_ms(ready):9.3f} {_ms(start):9.3f} "
            f"{_ms(end):9.3f} | {_ms(hop):8.3f} {_ms(stage):8.3f} "
            f"{_ms(rest):8.3f}")
    for r in results:
        step = r["cnn"]["steps"][-1]
        tot = [sum(b[i] for b in step["buckets"]) for i in range(4, 7)]
        busy = sum(b[3] - b[2] for b in step["buckets"])
        log(f"    rank {r['rank']} last step: channel start-to-end "
            f"{_ms(busy)} ms, in bucket spans {_ms(sum(tot))}: hops "
            f"{_ms(tot[0])}, stages outside hops {_ms(tot[1])}, rest "
            f"{_ms(tot[2])}; backward {_ms(step['backward_s'])} ms; step "
            f"{_ms(step['step_s'])} ms")

    # (e)
    for r in results:
        _require_lint(r["rank"], "smollm-360m overlapped",
                      r["lm_overlap"]["steps"])
    witness = [step["lint"]["witness"] for r in results
               for step in r["lm_overlap"]["steps"]]
    log(f"  (e) smollm-360m overlapped: the hop lint clean on every rank "
        f"and step (HL002 not required: its layer-stacked leaves and tied "
        f"embedding complete at the end of backward); buckets whose hops "
        f"all ended before the backward did, per rank and step {witness}")

    # (d)
    t = results[0]["trace"]
    require(t is not None and t["spans"] == t["events"] > 0,
            f"rank 0's trace did not reload: {t}")
    log(f"  (d) rank 0's trace: {t['events']} events, {t['bytes']} bytes, "
        f"{t['roots']} roots, reloaded through from_json; tracks "
        f"{t['tids']}")

    # (f)
    for r in results if results[0]["ipc_check"] is not None else ():
        c = r["ipc_check"]
        require(all(c["bits"].values()),
                f"rank {r['rank']}: hops through the waits on the card "
                f"differ from gloo's: {c['bits']}")
        require(all(n > 0 for n in c["waits"].values()),
                f"rank {r['rank']}: a channel enqueued no wait on the card "
                f"{c['waits']}")
        for part in ("lm", "cnn", "lm_overlap"):
            require(r[part]["device_waits"] > 0,
                    f"rank {r['rank']} ({part}): the main path enqueued no "
                    f"wait on the card")
    c = results[0]["ipc_check"]
    if c is None:
        log("  (f) not run: the ranks ran off the card")
    else:
        _log_ipc_check(results)
    log(f"  phase 11 {seconds:.1f} s on {gpu_line()}")
    return results


def _log_ipc_check(results):
    c = results[0]["ipc_check"]
    log(f"  (f) the channel's waits on the card (ipc_wait) against gloo: "
        f"{list(c['bits'])} bit for bit on every rank, waits per channel "
        f"on rank 0 {c['waits']}; waits on the main path per rank "
        f"(a)+(b)+(e) "
        f"{[sum(r[p]['device_waits'] for p in ('lm', 'cnn', 'lm_overlap')) for r in results]}; "
        f"a {PINGPONG_BYTES}-byte ring hop on {TRAIN_WORLD} ranks, ms per "
        f"hop per rank: card clock "
        f"{[round(r['ipc_check']['ms'], 4) for r in results]}, gloo "
        f"(host-staged, host clock) "
        f"{[round(r['ipc_check']['plain_ms'], 4) for r in results]}")


# ---------------------------------------------------------------------------
# phase 12: serving (prefill and decode through K6 and K7)
# ---------------------------------------------------------------------------

SERVE_DEVICE = "cuda"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 4096, 32   # (a) gemma-7b
PARITY_DECODE = 8                # (a) teacher-forced steps after 4096
GEMMA_PARAMS = 8_537_680_896     # 28 layers, the tied embedding
SMALL_PROMPT, SMALL_NEW = 128, 16                    # (b)
RANK_MESH, RANK_BATCH, RANK_PROMPT, RANK_NEW = "2x2", 4, 512, 32   # (c)
GATHER_REPS = 5
# (a)'s decode cast-bound, the reference's design: every step reads the
# f32 weights, writes their bf16 cast and reads it back; the function's
# own floor reads the f32 weights once.  Both add the KV cache's bytes.
DECODE_BYTES_PER_PARAM = 4 + 2 + 2
FLOOR_BYTES_PER_PARAM = 4
SERVE_KERNELS = ("fused_rmsnorm", "flash_attention_fwd")


def serve_args(**over):
    from repro_torch.launch.serve import parser
    args = parser().parse_args(["--arch", "gemma-7b", "--mesh", "1x1"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _serve_gemma_spec():
    """(a)'s model: gemma-7b as published, all 28 layers, bf16."""
    from repro_torch.configs import get_spec
    return get_spec("gemma-7b")


def _rank_args():
    """(c)'s launcher arguments: full-width smollm-360m on 2 x 2."""
    return serve_args(arch="smollm-360m", full=True, batch=RANK_BATCH,
                      prompt_len=RANK_PROMPT, new_tokens=RANK_NEW,
                      mesh=RANK_MESH, backend="cuda_ipc",
                      device=SERVE_DEVICE)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _count_calls(model, calls, finite):
    """``model`` with its prefill and decode step wrapped to record each
    call's K6/K7 launches, and to fold the finiteness of decode's logits
    into ``finite`` on the device (no sync)."""
    import dataclasses
    import torch

    def wrap(fn, kind):
        def call(*a):
            before = _counts()
            logits, cache = fn(*a)
            after = _counts()
            calls.append((kind, {k: after[k] - before[k]
                                 for k in SERVE_KERNELS}))
            if kind == "decode":
                ok = torch.isfinite(logits).all()
                finite[0] = ok if finite[0] is None else finite[0] & ok
            return logits, cache
        return call

    return dataclasses.replace(model, prefill=wrap(model.prefill, "prefill"),
                               decode_step=wrap(model.decode_step, "decode"))


def _token_check(model, seen):
    """``model`` with its prefill wrapped to count, on the device before
    the embedding lookup, the prompt's tokens outside ``[0, vocab)``.
    The count goes to pinned host memory in stream order (appended to
    ``seen``), so it can be read even after a device-side assert."""
    import dataclasses
    import torch
    vocab = model.spec.vocab_size

    def prefill(params, batch, max_seq=None):
        t = batch["tokens"]
        host = torch.empty((), dtype=torch.int64, pin_memory=t.is_cuda)
        host.copy_(((t < 0) | (t >= vocab)).sum(), non_blocking=True)
        seen.append(host)
        return model.prefill(params, batch, max_seq)

    return dataclasses.replace(model, prefill=prefill)


def _profiled(fn, cuda):
    """``fn()`` under ``torch.profiler`` (on CUDA): its output, the host
    wall ms around it (synchronised), the summed device ms of its
    kernels and their count."""
    import torch
    if not cuda:
        return {"out": fn()}
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(getattr(e, "device_time_total", 0) for e in kernels)
    return {"out": out, "wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
            "kernels": sum(e.count for e in kernels)}


def serve_gemma():
    """(a): full-width, full-depth gemma-7b served in this process through
    ``launch/serve.py::build_engine`` and ``ServeEngine``: batch 2, prompt
    4096, 32 greedy tokens.  K7 28 times in prefill and never in decode,
    K6 57 times per forward, tokens in range, decode logits finite; then
    decode against forward (prefill 4096 of a 4104-token batch, 8
    teacher-forced steps, the last logits against ``forward`` over all
    4104); the card at most 90% full.  Returns the record."""
    import torch
    from repro_torch import tree
    from repro_torch.core.hw import H100_SXM
    from repro_torch.data.synthetic import SyntheticText
    from repro_torch.launch.serve import build_engine, decode_ms
    from repro_torch.models import transformer

    spec = _serve_gemma_spec()
    cuda = torch.device(SERVE_DEVICE).type == "cuda"
    args = serve_args(full=True, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      new_tokens=SERVE_NEW, device=SERVE_DEVICE)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, batch = build_engine(args, spec=spec)
    _sync(SERVE_DEVICE)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(engine.params))
    log(f"  (a) {spec.name}: {spec.num_layers} layers, d_model "
        f"{spec.d_model}, {spec.num_heads}/{spec.num_kv_heads} heads of "
        f"{spec.resolved_head_dim}, vocab {spec.vocab_size}, {spec.dtype} "
        f"compute; {n_params} f32 parameters drawn on the card in "
        f"{init_s:.1f} s; batch {SERVE_BATCH}, prompt {SERVE_PROMPT} "
        f"(attn_full_seq_max {spec.attn_full_seq_max}), {SERVE_NEW} greedy "
        f"tokens, max_seq {engine.cfg.max_seq}")
    if spec.name == "gemma-7b":
        require(n_params == GEMMA_PARAMS,
                f"gemma-7b has {n_params} parameters, not {GEMMA_PARAMS}")
    calls, finite, checked = [], [None], []
    engine.model = _count_calls(_token_check(engine.model, checked), calls,
                                finite)
    host_toks = batch["tokens"]
    _reset_counts()                           # main path starts here
    try:
        out = engine.generate(batch)
    except Exception:
        # F7: were the prompt's tokens in range on the card before the
        # lookup?  The count sits in host memory, readable after a
        # device-side assert.
        log(f"  (a) the prompt's tokens out of [0, {spec.vocab_size}) on "
            f"the card before the lookup: {[int(h) for h in checked]}; on "
            f"the host {int(host_toks.min())}..{int(host_toks.max())}")
        raise
    totals = _counts()                        # main path ends here
    log(f"  (a) the prompt's tokens out of [0, {spec.vocab_size}) on the "
        f"card before the lookup: {[int(h) for h in checked]}")
    require(checked and not any(int(h) for h in checked),
            f"(a) out-of-range prompt tokens on the card: "
            f"{[int(h) for h in checked]}")
    scalar = _scalar_counts()
    k6 = 2 * spec.num_layers + 1
    k7 = spec.num_layers if SERVE_PROMPT > spec.attn_full_seq_max else 0
    kinds = [kind for kind, _ in calls]
    require(kinds == ["prefill"] + ["decode"] * SERVE_NEW,
            f"(a) ran {kinds}")
    if cuda:
        for i, (kind, got) in enumerate(calls):
            want = {"fused_rmsnorm": k6,
                    "flash_attention_fwd": k7 if kind == "prefill" else 0}
            require(got == want, f"(a) call {i} ({kind}) launched {got}, "
                                 f"not {want}")
    require(out.shape == (SERVE_BATCH, SERVE_NEW)
            and out.min() >= 0 and out.max() < spec.vocab_size,
            f"(a) tokens out of range: {out}")
    require(bool(finite[0]), "(a) non-finite decode logits")
    timing = engine.timing
    dec_ms = decode_ms(timing)
    total_s = timing["prefill_s"] + sum(timing["decode_s"])
    cd = spec.compute_dtype
    cache_bytes = (2 * spec.num_layers * SERVE_BATCH
                   * transformer.cache_len(spec, engine.cfg.max_seq)
                   * spec.num_kv_heads * spec.resolved_head_dim
                   * torch.empty((), dtype=cd).element_size())
    bw = H100_SXM.hbm_bandwidth
    bound = (n_params * DECODE_BYTES_PER_PARAM + cache_bytes) / bw * 1e3
    floor = (n_params * FLOOR_BYTES_PER_PARAM + cache_bytes) / bw * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    log(f"  (a) launches per forward: prefill {calls[0][1]}, decode "
        f"{calls[1][1]} (x{SERVE_NEW}); tokens row 0 {out[0][:12].tolist()}")
    log(f"  (a) prefill {timing['prefill_s']:.4f} s; decode "
        f"{dec_ms:.3f} ms/token (median of steps 2-{SERVE_NEW}; steps "
        f"{[round(x * 1e3, 2) for x in timing['decode_s']]} ms); "
        f"{SERVE_BATCH * SERVE_NEW / total_s:.1f} tokens/s over the "
        f"generation, {SERVE_BATCH / dec_ms * 1e3:.1f} in decode; peak "
        f"{peak:.2f} GiB allocated")
    log(f"  (a) decode cast-bound, the reference's design (f32 weights "
        f"read, bf16 cast written and read: {n_params} x "
        f"{DECODE_BYTES_PER_PARAM} B, plus the KV cache read, {cache_bytes} "
        f"B, over {bw / 1e12:.2f} TB/s) {bound:.2f} ms, measured/cast-bound "
        f"{dec_ms / bound:.2f}; the step's own floor (f32 weights read "
        f"once, {FLOOR_BYTES_PER_PARAM} B each, plus the cache) "
        f"{floor:.2f} ms, measured/floor {dec_ms / floor:.2f}")
    if cuda:
        # A decode step's casts alone, on the device's clock: each body
        # weight once, the embedding twice (the lookup and the head).
        leaves = [w for ws in tree.leaves(engine.params["body"])
                  for w in ws.unbind(0)] + [engine.params["embed"]] * 2
        def casts():
            for w in leaves:
                w.to(spec.compute_dtype)     # freed at once, as in decode

        cast_ms = time_ms(casts, reps=3)
        log(f"  (a) a decode step's weight casts alone {cast_ms:.2f} ms "
            f"(device time, {len(leaves)} casts): {cast_ms / dec_ms:.1%} "
            f"of the measured step")

    # Decode against forward, as the reference's test_decode_parity.py.
    t1 = time.perf_counter()
    model = engine.model
    toks = SyntheticText(spec.vocab_size, batch=SERVE_BATCH,
                         seq_len=SERVE_PROMPT + PARITY_DECODE,
                         seed=1).batch_at(0)["tokens"].to(SERVE_DEVICE)
    last = SERVE_PROMPT + PARITY_DECODE - 1
    with torch.inference_mode():
        _, cache = model.prefill(engine.params,
                                 {"tokens": toks[:, :SERVE_PROMPT]},
                                 SERVE_PROMPT + PARITY_DECODE)
        for t in range(SERVE_PROMPT, last):
            got, cache = model.decode_step(engine.params, cache,
                                           toks[:, t:t + 1])
        # The last teacher-forced step under the profiler: the card's
        # busy time in a decode step against the host's.
        busy = _profiled(lambda: model.decode_step(
            engine.params, cache, toks[:, last:last + 1]), cuda)
        got, cache = busy.pop("out")
        del cache
        want = transformer.forward(engine.params, toks, spec)[:, -1] \
            .float()
    got = got.float()
    rel = float((want - got).abs().max() / (want.abs().max() + 1e-9))
    log(f"  (a) decode = forward: prefill {SERVE_PROMPT}, {PARITY_DECODE} "
        f"teacher-forced steps, last logits against forward over "
        f"{SERVE_PROMPT + PARITY_DECODE} tokens: rel err {rel:.4e} "
        f"(required < 0.05) in {time.perf_counter() - t1:.1f} s")
    require(rel < 0.05, f"(a) decode differs from forward: rel {rel}")
    if cuda:
        log(f"  (a) one decode step profiled: {busy['kernels']} kernels, "
            f"card busy {busy['device_ms']:.2f} ms of {busy['wall_ms']:.2f} "
            f"ms host wall ({busy['device_ms'] / busy['wall_ms']:.1%}); "
            f"the profiler slows the host")
    held, total = 0.0, 1.0
    if cuda:
        card, released = _card_in_use_gib(1)
        held = card + released
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        log(f"  (a) the card in use at its peak {held:.2f} of {total:.2f} "
            f"GiB ({held / total:.1%}); peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        require(held <= 0.9 * total,
                f"(a) holds {held:.2f} GiB of the card, more than 90%")
    return {"totals": totals, "scalar": scalar,
            "prefill_s": timing["prefill_s"],
            "decode_ms": dec_ms, "bound_ms": bound, "floor_ms": floor,
            "rel": rel,
            "peak_gib": peak, "held_gib": held, "n_params": n_params}


def serve_card_vs_host():
    """(b): the float32 gemma (``reduced()``, head_dim 256) at prompt 128,
    above its attn_full_seq_max of 64, on the card (K6/K7) and on the
    host's plain versions from the same parameters: prefill logits
    within K7's f32 tolerance, 16 greedy tokens equal."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import ServeEngine

    spec = dataclasses.replace(_serve_gemma_spec().reduced(), head_dim=256,
                               dtype="float32")
    args = serve_args(full=False, batch=SERVE_BATCH, prompt_len=SMALL_PROMPT,
                      new_tokens=SMALL_NEW, device="cpu")
    host, batch = build_engine(args, spec=spec)
    card = ServeEngine(host.model, tree.tree_map(
        lambda t: t.detach().to(SERVE_DEVICE), host.params), None, host.cfg,
        SERVE_DEVICE)
    model, tokens = host.model, batch["tokens"]
    with torch.inference_mode():
        want, _ = model.prefill(host.params, {"tokens": tokens},
                                host.cfg.max_seq)
        before = _counts()
        got, _ = model.prefill(card.params,
                               {"tokens": tokens.to(SERVE_DEVICE)},
                               host.cfg.max_seq)
        after = _counts()
    launched = {k: after[k] - before[k] for k in SERVE_KERNELS}
    ex = _excess(got.cpu(), want, 2e-5, 1e-4)
    err = float((got.cpu() - want).abs().max())
    out_host, out_card = host.generate(batch), card.generate(batch)
    log(f"  (b) float32 gemma ({spec.num_layers} layers, d_model "
        f"{spec.d_model}, head_dim {spec.resolved_head_dim}), prompt "
        f"{SMALL_PROMPT} (attn_full_seq_max {spec.attn_full_seq_max}): "
        f"prefill launched {launched} on the card; prefill logits card vs "
        f"host max abs {err:.3e}, max err/tol {ex:.3f} at K7's f32 "
        f"tolerance atol 2e-5 / rtol 1e-4 (K6's in phase 2: rtol 1e-5); "
        f"{SMALL_NEW} greedy tokens equal: "
        f"{bool((out_host == out_card).all())}")
    if torch.device(SERVE_DEVICE).type == "cuda":
        require(launched == {"fused_rmsnorm": 2 * spec.num_layers + 1,
                             "flash_attention_fwd": spec.num_layers},
                f"(b) the card's prefill launched {launched}")
    require(ex <= 1.0, f"(b) card and host prefill logits disagree: {ex}")
    require((out_host == out_card).all(),
            f"(b) greedy tokens differ: {out_host} vs {out_card}")


def _bits(t):
    import torch
    view = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(view).cpu().numpy()


def serve_rank(rank, world, args):
    """(c) on one rank: ``launch/serve.py::build_engine`` on ``--mesh 2x2`` (this
    rank's shards, groups on the world's cuda_ipc), the engine's
    generation with its launches and gather-boundary calls counted, the
    gather boundary timed alone and its output held bit for bit to the
    full parameters drawn again from ``args.seed`` as ``build_engine``
    draws them, then a one-rank engine in this process on this data
    rank's rows with the drawn parameters."""
    import torch
    from repro_torch import tree
    from repro_torch.core import manual
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import ServeEngine

    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    engine, batch = build_engine(args)
    transports = {ax: g.transport for ax, g in engine.groups.items()}
    last = {}

    def recording(eng, key):
        orig = eng._sample

        def sample(logits, gen):
            last[key] = logits
            return orig(logits, gen)
        return sample

    engine._sample = recording(engine, "mesh")
    gathers = [0]
    orig_gather = manual.gather_params

    def counted_gather(*a):
        gathers[0] += 1
        return orig_gather(*a)

    manual.gather_params = counted_gather
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()                           # main path starts here
    out = engine.generate(batch)
    totals = _counts()                        # main path ends here
    scalar = _scalar_counts()
    manual.gather_params = orig_gather
    step = engine._decode
    _sync(args.device)
    t0 = time.perf_counter()
    for _ in range(GATHER_REPS):
        full = step.full(engine.params)
    _sync(args.device)
    gather_s = (time.perf_counter() - t0) / GATHER_REPS
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    drawn = engine.model.init(gen, args.device).tree()
    got, want = tree.leaves_with_path(full), tree.leaves_with_path(drawn)
    differ = ["/".join(map(str, p)) for (p, a), (q, b) in zip(got, want)
              if p != q or not _bits_equal(a, b)]
    if len(got) != len(want):
        differ.append(f"{len(got)} leaves, not {len(want)}")
    del full
    rows = step.rows
    one = ServeEngine(engine.model, drawn, None, engine.cfg, engine.device)
    one._sample = recording(one, "one")
    one_out = one.generate({"tokens": batch["tokens"][rows]})
    return {"rank": rank, "tokens": out, "one_tokens": one_out,
            "rows": (rows.start, rows.stop), "last": _bits(last["mesh"]),
            "one_last": _bits(last["one"]), "timing": engine.timing,
            "gather_s": gather_s, "gathers": gathers[0], "totals": totals,
            "gathered_differ": differ,
            "scalar": scalar,
            "transports": transports,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
            if cuda else 0.0}


def serve_on_ranks():
    """(c): full-width smollm-360m served on 4 cuda_ipc ranks sharing the
    card, ``--mesh 2x2``: the weights rebuilt through the gather boundary
    at every prefill and decode step; each data rank's tokens and last
    logits bit for bit a one-rank run on its 2 rows; the two model ranks
    of a data index bit for bit each other.  Returns each rank's record."""
    from repro_torch.configs import get_spec
    from repro_torch.core.dist import run_ranks
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.serve import decode_ms

    args = _rank_args()
    _, data, model = parse_mesh(args.mesh)
    world = data * model
    spec = get_spec(args.arch) if args.full else get_spec(args.arch).reduced()
    log(f"  (c) {args.arch} at full width on --mesh {args.mesh} (data "
        f"{data} x model {model}, {world} ranks on one card, "
        f"{args.backend}): global batch {args.batch}, prompt "
        f"{args.prompt_len}, {args.new_tokens} greedy tokens")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(serve_rank, world, (args,), backend=args.backend,
                            rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1) // world),
                            timeout_s=600)
    log(f"  (c) {world} ranks done in {time.perf_counter() - t0:.1f} s; "
        f"groups {results[0]['transports']}")
    k6 = (2 * spec.num_layers + 1) * (1 + args.new_tokens)
    for r in results:
        rank = r["rank"]
        lo, hi = r["rows"]
        require(r["gathers"] == 1 + args.new_tokens,
                f"rank {rank}: the gather boundary ran {r['gathers']} "
                f"times, not once per prefill and decode step")
        require(not r["gathered_differ"],
                f"rank {rank}: the gather boundary's parameters differ from "
                f"the drawn ones at {r['gathered_differ'][:5]}")
        require(r["transports"]["model"] == args.backend,
                f"rank {rank}: groups {r['transports']}")
        if args.device == "cuda":
            require(r["totals"]["fused_rmsnorm"] == k6
                    and r["totals"]["flash_attention_fwd"] == 0,
                    f"rank {rank}: launched {r['totals']}")
        require((r["tokens"][lo:hi] == r["one_tokens"]).all(),
                f"rank {rank}: tokens of rows {lo}:{hi} differ from the "
                f"one-rank run's")
        require((r["last"][lo:hi] == r["one_last"]).all(),
                f"rank {rank}: last logits of rows {lo}:{hi} differ from "
                f"the one-rank run's")
        require((r["tokens"] == results[0]["tokens"]).all()
                and (r["last"] == results[0]["last"]).all(),
                f"rank {rank}: tokens or logits differ from rank 0's")
    log(f"  (c) every rank's gathered parameters bit for bit the ones "
        f"drawn from the seed; its tokens and last logits bit for bit the "
        f"one-rank runs on its rows (from the drawn parameters) and each "
        f"other's; gather boundary "
        f"{results[0]['gathers']} calls per generation")
    for r in results:
        log(f"  (c) rank {r['rank']} rows {r['rows']}: prefill "
            f"{r['timing']['prefill_s']:.4f} s, decode "
            f"{decode_ms(r['timing']):.3f} ms/token; the gather boundary "
            f"alone {r['gather_s'] * 1e3:.3f} ms per step; peak "
            f"{r['peak_gib']:.2f} GiB")
    return results


def run_serve_phase():
    """Phase 12: (a) gemma-7b at full width and depth, (b) card against
    host, (c) smollm-360m on a data x model mesh of ranks."""
    import torch
    t0 = time.perf_counter()
    gemma = serve_gemma()
    if torch.device(SERVE_DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    serve_card_vs_host()
    if torch.device(SERVE_DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    ranks = serve_on_ranks()
    log(f"  phase 12 {time.perf_counter() - t0:.1f} s on {gpu_line()}")
    return {"gemma": gemma, "ranks": ranks}


# ---------------------------------------------------------------------------
# phase 13: the rest of the transformer family (MoE, MLA, the VLM)
# ---------------------------------------------------------------------------

DSV2, PHI3, GRANITE_MOE = ("deepseek-v2-lite-16b", "phi-3-vision-4.2b",
                           "granite-moe-1b-a400m")
FAMILY_PARAMS = {DSV2: 15_706_470_400, PHI3: 3_822_259_200}
DSV2_PROMPT = 2048                 # (a) batch SERVE_BATCH
PHI3_TEXT = 3520                   # (b), (d): + 576 patches = 4096 positions
FAMILY_NEW = 32
NO_DROP = 8.0                      # the reference test's no-drop capacity
DECODE_FAITH = 1.5                 # (a) bf16 decode's error / forward's
FAMILY_WORLD, FAMILY_STEPS = 2, 2
GRANITE_MOE_LAYERS = 16            # (c) cut: depth, 16 of 24 (17: 93.3%)
PHI3_TRAIN_LAYERS = 4              # (d) cut: depth, 4 of 32
FAMILY_SMALL_PROMPT = 96           # (e): above the reduced attn_full_seq_max


def _family_spec(arch):
    """(a)'s and (b)'s model: ``arch`` as published, all layers, bf16."""
    from repro_torch.configs import get_spec
    return get_spec(arch)


def _combine_bits(params, spec, device):
    """One MoE layer at the served width on one call's tokens, twice:
    ``(y, aux, drop)`` must repeat bit for bit (the combine inverts the
    sort instead of scatter-adding)."""
    import torch
    from repro_torch.models import moe
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((SERVE_BATCH, 256, spec.d_model), generator=gen,
                    device=device).to(spec.compute_dtype)
    lp = {k: v[0] for k, v in params["body"]["moe"].items()
          if not isinstance(v, dict)}
    if "shared" in params["body"]["moe"]:
        lp["shared"] = {k: v[0] for k, v in
                        params["body"]["moe"]["shared"].items()}
    with torch.inference_mode():
        a = moe.moe_forward(lp, x, spec)
        b = moe.moe_forward(lp, x, spec)
    return all(bits_equal(u, v) for u, v in zip(a, b))


def _cache_bytes(model, rows, max_seq):
    from repro_torch import tree
    tpl = model.init_cache(rows, max_seq, device="meta")
    return sum(t.numel() * t.element_size() for t in tree.leaves(tpl)
               if getattr(t, "ndim", 0) > 0)


def _release(cuda):
    """Give the allocator's cached blocks back to the card."""
    import torch
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class _routing:
    """Patch ``moe.top_k`` for a ``with`` block, which receives the list
    of each MoE call's expert indices, (tokens, k), in call order.  With
    ``forced`` (such indices, in call order) each call takes its entry's
    experts instead of its own, weighted by its own probabilities."""

    def __init__(self, forced=None):
        self.forced = None if forced is None else iter(forced)

    def __enter__(self):
        from repro_torch.models import moe
        self.seen, self.orig = [], moe.top_k

        def top_k(probs, k):
            if self.forced is None:
                w, i = self.orig(probs, k)
            else:
                i = next(self.forced).to(probs.device) \
                    .reshape(*probs.shape[:-1], k)
                w = probs.gather(-1, i)
            self.seen.append(i.reshape(-1, k))
            return w, i

        moe.top_k = top_k
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self.orig


def _rel(got, want):
    """The max difference relative to the largest magnitude of ``want``."""
    return float((want - got).abs().max() / (want.abs().max() + 1e-9))


def _decode_vs_forward(params, spec, toks, extra, prompt, positions,
                       profile, pinned=None):
    """``(got, want, flips, profiled, routes)``: prefill ``prompt`` of
    ``toks`` (after ``extra``'s patches), teacher-force the rest: ``got``
    the last step's logits, ``want`` ``forward``'s over all at the last
    position (f32); ``flips`` the token-layers whose experts the decode
    steps and the forward chose apart, with their count (None without
    experts); ``profiled`` the last step under the profiler (when
    ``profile``); ``routes`` the forward's expert indices per MoE layer.
    With ``pinned`` (an earlier run's ``routes``) the prefill, the
    decode steps and the forward all take those experts."""
    import torch
    from repro_torch.models import build_model, transformer
    model = build_model(spec)
    b, n_all = toks.shape
    last = n_all - 1
    forced = None
    if pinned:
        per = [r.view(b, n_all, -1) for r in pinned]
        forced = [r[:, :prompt] for r in per] + [
            r[:, t] for t in range(prompt, n_all) for r in per]
    with torch.inference_mode():
        with _routing(forced) as seen:
            _, cache = model.prefill(params, {"tokens": toks[:, :prompt],
                                              **extra},
                                     positions + n_all - prompt)
            seen.clear()
            for t in range(prompt, last):
                got, cache = model.decode_step(params, cache,
                                               toks[:, t:t + 1])
            prof = _profiled(lambda: model.decode_step(
                params, cache, toks[:, last:last + 1]), profile)
        got, cache = prof.pop("out")
        del cache
        # The forward's blocks are a few tokens larger than the
        # prefill's: without this the cached ones stay beside them.
        _release(toks.is_cuda)
        with _routing(pinned) as fwd:
            want = transformer.forward(params, toks, spec,
                                       patches=extra.get("patches")
                                       )[:, -1].float()
    flips = None
    if fwd:
        per_token = [r.view(b, n_all, -1)[:, t] for t in range(prompt, n_all)
                     for r in fwd]
        differ = sum(int((torch.sort(d, -1)[0] != torch.sort(f, -1)[0])
                         .any(-1).sum()) for d, f in zip(seen, per_token))
        flips = (differ, b * (n_all - prompt) * len(fwd))
    return got.float(), want, flips, prof, fwd


def serve_family(arch, prompt, label):
    """(a) / (b): ``arch`` at full width and full depth served in this
    process through ``launch/serve.py::build_engine`` and ``ServeEngine``:
    batch 2, ``prompt`` tokens (after the VLM's 576 patches), 32 greedy
    tokens.  K6 2L + 1 times per forward, K7 once per layer in a prefill
    above ``attn_full_seq_max`` (never under MLA, never in decode),
    tokens in range before the lookup (F7), decode logits finite, the
    engine's cache sized with the patches (F8); an MoE layer's output
    twice bit for bit; then decode against forward at the no-drop
    capacity (prefill ``prompt`` of ``prompt + 8`` tokens, 8
    teacher-forced steps, the last logits against ``forward`` over all;
    with experts in bf16, printed with its routing flips, and in
    float32, held); the card at most 90% full.  Returns the record."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.core.hw import H100_SXM
    from repro_torch.data.synthetic import SyntheticText
    from repro_torch.launch.serve import build_engine, decode_ms

    spec = _family_spec(arch)
    cuda = torch.device(SERVE_DEVICE).type == "cuda"
    args = serve_args(arch=arch, full=True, batch=SERVE_BATCH,
                      prompt_len=prompt, new_tokens=FAMILY_NEW,
                      device=SERVE_DEVICE)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, batch = build_engine(args, spec=spec)
    _sync(SERVE_DEVICE)
    init_s = time.perf_counter() - t0
    _release(cuda)                  # the layer-by-layer draws' blocks
    n_params = sum(t.numel() for t in tree.leaves(engine.params))
    n_img = batch["patches"].shape[1] if "patches" in batch else 0
    positions = n_img + prompt
    desc = (f"{spec.num_layers} layers ({spec.first_dense_layers} dense "
            f"prefix), d_model {spec.d_model}, {spec.num_heads} heads")
    if spec.attention_type == "mla":
        desc += (f" (MLA: kv_lora_rank {spec.kv_lora_rank}, rope "
                 f"{spec.qk_rope_dim}, nope {spec.qk_nope_dim})")
    else:
        desc += f" of {spec.resolved_head_dim}"
    if spec.num_experts:
        desc += (f", {spec.num_experts} experts top-{spec.top_k} + "
                 f"{spec.num_shared_experts} shared, capacity_factor "
                 f"{spec.capacity_factor}")
    log(f"  {label} {spec.name}: {desc}"
        f", vocab {spec.vocab_size}, {spec.dtype} compute; {n_params} f32 "
        f"parameters drawn on the card in {init_s:.1f} s; batch "
        f"{SERVE_BATCH}, {n_img} patches + prompt {prompt} = {positions} "
        f"positions (attn_full_seq_max {spec.attn_full_seq_max}), "
        f"{FAMILY_NEW} greedy tokens, max_seq {engine.cfg.max_seq}")
    if spec.name == arch:
        require(n_params == FAMILY_PARAMS[arch],
                f"{label} {arch} has {n_params} parameters, not "
                f"{FAMILY_PARAMS[arch]}")
    require(engine.cfg.max_seq == positions + FAMILY_NEW + 1,
            f"{label} F8: the engine sized max_seq {engine.cfg.max_seq} for "
            f"{positions} positions and {FAMILY_NEW} tokens")
    calls, finite, checked = [], [None], []
    engine.model = _count_calls(_token_check(engine.model, checked), calls,
                                finite)
    host_toks = batch["tokens"]
    _reset_counts()                           # main path starts here
    try:
        out = engine.generate(batch)
    except Exception:
        log(f"  {label} the prompt's tokens out of [0, {spec.vocab_size}) "
            f"on the card before the lookup: {[int(h) for h in checked]}; "
            f"on the host {int(host_toks.min())}..{int(host_toks.max())}")
        raise
    totals = _counts()                        # main path ends here
    scalar = _scalar_counts()
    log(f"  {label} the prompt's tokens out of [0, {spec.vocab_size}) on "
        f"the card before the lookup: {[int(h) for h in checked]}")
    require(checked and not any(int(h) for h in checked),
            f"{label} out-of-range prompt tokens on the card: "
            f"{[int(h) for h in checked]}")
    k6 = 2 * spec.num_layers + 1
    k7 = spec.num_layers if (positions > spec.attn_full_seq_max
                             and spec.attention_type != "mla") else 0
    kinds = [kind for kind, _ in calls]
    require(kinds == ["prefill"] + ["decode"] * FAMILY_NEW,
            f"{label} ran {kinds}")
    if cuda:
        for i, (kind, got) in enumerate(calls):
            want = {"fused_rmsnorm": k6,
                    "flash_attention_fwd": k7 if kind == "prefill" else 0}
            require(got == want, f"{label} call {i} ({kind}) launched "
                                 f"{got}, not {want}")
    # Greedy tokens come from the logits over the padded vocabulary (the
    # embedding's rows), as in the reference: phi-3-vision's 32064 words
    # pad to 32256.
    require(out.shape == (SERVE_BATCH, FAMILY_NEW)
            and out.min() >= 0 and out.max() < spec.padded_vocab,
            f"{label} tokens out of [0, {spec.padded_vocab}): {out}")
    require(bool(finite[0]), f"{label} non-finite decode logits")
    if spec.num_experts:
        same = _combine_bits(engine.params, spec, SERVE_DEVICE)
        log(f"  {label} one MoE layer ({SERVE_BATCH} x 256 tokens) twice: "
            f"y, aux and drop bit for bit: {same}")
        require(same, f"{label} the MoE combine is not deterministic")
    timing = engine.timing
    dec_ms = decode_ms(timing)
    total_s = timing["prefill_s"] + sum(timing["decode_s"])
    cache_bytes = _cache_bytes(engine.model, SERVE_BATCH, engine.cfg.max_seq)
    bw = H100_SXM.hbm_bandwidth
    bound = (n_params * DECODE_BYTES_PER_PARAM + cache_bytes) / bw * 1e3
    floor = (n_params * FLOOR_BYTES_PER_PARAM + cache_bytes) / bw * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    log(f"  {label} launches per forward: prefill {calls[0][1]}, decode "
        f"{calls[1][1]} (x{FAMILY_NEW}); tokens row 0 "
        f"{out[0][:12].tolist()}")
    log(f"  {label} prefill {timing['prefill_s']:.4f} s; decode "
        f"{dec_ms:.3f} ms/token (median of steps 2-{FAMILY_NEW}; steps "
        f"{[round(x * 1e3, 2) for x in timing['decode_s']]} ms); "
        f"{SERVE_BATCH * FAMILY_NEW / total_s:.1f} tokens/s over the "
        f"generation, {SERVE_BATCH / dec_ms * 1e3:.1f} in decode; peak "
        f"{peak:.2f} GiB allocated")
    log(f"  {label} decode cast-bound (f32 weights read, bf16 cast written "
        f"and read: {n_params} x {DECODE_BYTES_PER_PARAM} B, plus the cache "
        f"read, {cache_bytes} B, over {bw / 1e12:.2f} TB/s) {bound:.2f} ms, "
        f"measured/cast-bound {dec_ms / bound:.2f}; floor (f32 weights read "
        f"once) {floor:.2f} ms, measured/floor {dec_ms / floor:.2f}")

    # Decode against forward, the reference's criterion, at the no-drop
    # capacity for the experts.  With experts in bf16 both differ from
    # the float32 forward by more than the criterion's 0.05 (at
    # deepseek-v2-lite's depth, with routing pinned alike: 0.17): bf16
    # rounding in every layer, and on top the experts chosen apart where
    # router logits tie or nearly tie.  So with experts the bf16 run is
    # printed with its routing flips, decode = forward is held in
    # float32 (same parameters, no casts), and with the prefill, the
    # decode steps and the forward pinned to the float32 forward's
    # experts, the bf16 decode is held no farther from the float32
    # forward than DECODE_FAITH times the bf16 forward.
    spec8 = dataclasses.replace(spec, capacity_factor=NO_DROP) \
        if spec.num_experts else spec
    toks = SyntheticText(spec.vocab_size, batch=SERVE_BATCH,
                         seq_len=prompt + PARITY_DECODE,
                         seed=1).batch_at(0)["tokens"].to(SERVE_DEVICE)
    extra = {k: v.to(SERVE_DEVICE) for k, v in batch.items()
             if k == "patches"}
    parity = {}

    def run(pspec, profile=False, pinned=None):
        # Each run's blocks differ in size from the last's (f32 against
        # bf16, capacity 8 against 1.25): give the cached ones back first.
        _release(cuda)
        t1 = time.perf_counter()
        got, want, flips, prof, routes = _decode_vs_forward(
            engine.params, pspec, toks, extra, prompt, positions, profile,
            pinned)
        rel = _rel(got, want)
        held_to = not spec.num_experts or pspec.dtype == "float32"
        how = (f"; prefill, decode and forward pinned to the float32 "
               f"forward's experts in {len(routes)} MoE layers" if pinned
               else f"; routing flips, decode against forward, {flips[0]} "
               f"of {flips[1]} token-layers" if flips else "")
        log(f"  {label} decode = forward ({pspec.dtype}, capacity_factor "
            f"{pspec.capacity_factor}): prefill {positions}, "
            f"{PARITY_DECODE} teacher-forced steps, last logits against "
            f"forward over {positions + PARITY_DECODE} positions: rel err "
            f"{rel:.4e} ({'required < 0.05' if held_to else 'printed'})"
            f"{how} in {time.perf_counter() - t1:.1f} s")
        if held_to:
            require(rel < 0.05,
                    f"{label} decode differs from forward: rel {rel}")
        parity[f"{pspec.dtype}{' pinned' if pinned else ''}"] = rel
        return got, want, prof, routes

    busy = run(spec8, cuda)[2]
    if spec.num_experts:
        _, want32, _, routes32 = run(dataclasses.replace(spec8,
                                                         dtype="float32"))
        got, want, _, _ = run(spec8, pinned=routes32)
        dec_err, fwd_err = _rel(got, want32), _rel(want, want32)
        log(f"  {label} pinned to the float32 forward's experts, against "
            f"its last logits: bf16 decode rel {dec_err:.4e}, bf16 forward "
            f"rel {fwd_err:.4e} (decode/forward {dec_err / fwd_err:.3f}, "
            f"required <= {DECODE_FAITH})")
        require(dec_err <= DECODE_FAITH * fwd_err,
                f"{label} the bf16 decode is {dec_err} from the float32 "
                f"forward, the bf16 forward {fwd_err}")
        parity["bfloat16 decode / forward, from float32"] = \
            dec_err / fwd_err
    if cuda:
        log(f"  {label} one decode step profiled: {busy['kernels']} "
            f"kernels, card busy {busy['device_ms']:.2f} ms of "
            f"{busy['wall_ms']:.2f} ms host wall "
            f"({busy['device_ms'] / busy['wall_ms']:.1%}); the profiler "
            f"slows the host")
    held, total = 0.0, 1.0
    if cuda:
        card, released = _card_in_use_gib(1)
        held = card + released
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        log(f"  {label} the card in use at its peak {held:.2f} of "
            f"{total:.2f} GiB ({held / total:.1%}); peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        require(held <= 0.9 * total,
                f"{label} holds {held:.2f} GiB of the card, more than 90%")
    return {"totals": totals, "scalar": scalar,
            "prefill_s": timing["prefill_s"], "decode_ms": dec_ms,
            "bound_ms": bound, "floor_ms": floor, "rel": parity,
            "peak_gib": peak, "held_gib": held, "n_params": n_params,
            "kernels_per_step": busy.get("kernels")}


def family_train(arch, layers, seq, label):
    """(c) / (d): ``arch`` at full width, depth cut to ``layers``, trained
    on 2 ``cuda_ipc`` ranks sharing the card through ``run_phase``
    (``rhd_rsa`` + ``int8`` fused hops, K5 AdamW, batch 1 per rank,
    ``seq`` text tokens after the VLM's patches): K7 and K8 once per
    layer per step, the card at most 90% full; then the reduced float32
    spec on the card and on the host.  Returns each rank's record."""
    import dataclasses
    import torch
    from repro_torch.configs import get_spec
    full = get_spec(arch)
    spec = dataclasses.replace(full, num_layers=layers)
    small_spec = dataclasses.replace(full.reduced(), dtype="float32")
    n_img = spec.num_image_tokens if spec.family == "vlm" else 0
    ff = (f"{spec.num_experts} experts top-{spec.top_k} of d_ff "
          f"{spec.moe_d_ff}" if spec.num_experts else f"d_ff {spec.d_ff}")
    log(f"  {label} {arch} at full width (d_model {spec.d_model}, "
        f"{spec.num_heads} heads of {spec.resolved_head_dim}, {ff}"
        f", vocab {spec.vocab_size}); cut: depth, {layers} of "
        f"{full.num_layers} layers; {n_img} patches + {seq} tokens = "
        f"{n_img + seq} positions")
    args = train_args(arch=arch, full=True, batch=FAMILY_WORLD, seq=seq,
                      steps=FAMILY_STEPS, device="cuda")
    small = train_args(arch=arch, full=False, batch=2 * FAMILY_WORLD,
                       seq=128, steps=2, dtype="float32")
    results = run_phase(FAMILY_WORLD, args, small,
                        tuple(k for k in KERNELS if k != "fused_reduce"),
                        spec=spec, small_spec=small_spec, backend="cuda_ipc")
    for r in results:
        for s_, rec in enumerate(r["steps"]):
            for k in ("flash_attention_fwd", "flash_attention_bwd"):
                require(rec["launches"][k] == layers,
                        f"{label} rank {r['rank']} step {s_ + 1}: {k} "
                        f"launched {rec['launches'][k]} times, not once per "
                        f"layer")
    for s_, rec in enumerate(results[0]["steps"], 1):
        log(f"  {label} step {s_}: ce {rec['ce']:.5f} aux {rec['aux']:.5f} "
            f"drop {rec['drop']:.5f} step_s {rec['step_s']:.3f}")
    log(f"  {label} the aggregate timed alone per rank "
        f"{[round(r['breakdown']['aggregate_s'], 4) for r in results]} s")
    if args.device != "cuda":
        return results
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    held = max(r["card_gib"] for r in results) + sum(
        r["released_gib"] for r in results)
    log(f"  {label} the card in use at its peak {held:.2f} of {total:.2f} "
        f"GiB ({held / total:.1%}); GiB allocated at peak per rank "
        f"{[round(r['peak_gib'], 2) for r in results]}")
    require(held <= 0.9 * total,
            f"{label} holds {held:.2f} GiB of the card, more than 90%: cut "
            f"its layers")
    return results


def family_card_vs_host():
    """(e): the reduced float32 specs of the three (``attn_full_seq_max``
    64, so phi-3-vision's flash path runs at head_dim 64) at prompt 96
    on the card (K6/K7) and on the host's plain versions from the same
    parameters: prefill logits within K7's f32 tolerance, the routing
    equal, 16 greedy tokens equal."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    for arch in (GRANITE_MOE, DSV2, PHI3):
        spec = dataclasses.replace(_family_spec(arch).reduced(),
                                   dtype="float32")
        args = serve_args(arch=arch, full=False, batch=SERVE_BATCH,
                          prompt_len=FAMILY_SMALL_PROMPT,
                          new_tokens=SMALL_NEW, device="cpu")
        host, batch = build_engine(args, spec=spec)
        card = ServeEngine(host.model, tree.tree_map(
            lambda t: t.detach().to(SERVE_DEVICE), host.params), None,
            host.cfg, SERVE_DEVICE)
        model = host.model
        on_card = {k: v.to(SERVE_DEVICE) for k, v in batch.items()}
        routes = {}
        with torch.inference_mode():
            want, _ = model.prefill(host.params, batch, host.cfg.max_seq)
            before = _counts()
            got, _ = model.prefill(card.params, on_card, host.cfg.max_seq)
            after = _counts()
            for where, params, b in (("host", host.params, batch),
                                     ("card", card.params, on_card)):
                with _routing() as routes[where]:
                    transformer.forward(params, b["tokens"], spec,
                                        patches=b.get("patches"))
        launched = {k: after[k] - before[k] for k in SERVE_KERNELS}
        ex = _excess(got.cpu(), want, 2e-5, 1e-4)
        same_routes = len(routes["host"]) == len(routes["card"]) and all(
            torch.equal(a, b.cpu()) for a, b in zip(routes["host"],
                                                     routes["card"]))
        out_host, out_card = host.generate(batch), card.generate(batch)
        n_img = batch["patches"].shape[1] if "patches" in batch else 0
        log(f"  (e) float32 {spec.name} ({spec.num_layers} layers, d_model "
            f"{spec.d_model}, {spec.attention_type}), {n_img} patches + "
            f"prompt {FAMILY_SMALL_PROMPT}: prefill launched {launched} on "
            f"the card; prefill logits max err/tol {ex:.3f} (K7's f32 "
            f"tolerance atol 2e-5 / rtol 1e-4); routing of "
            f"{len(routes['card'])} MoE layers equal: {same_routes}; "
            f"{SMALL_NEW} greedy tokens equal: "
            f"{bool((out_host == out_card).all())}")
        if torch.device(SERVE_DEVICE).type == "cuda":
            positions = n_img + FAMILY_SMALL_PROMPT
            k7 = spec.num_layers if (positions > spec.attn_full_seq_max and
                                     spec.attention_type != "mla") else 0
            require(launched == {"fused_rmsnorm": 2 * spec.num_layers + 1,
                                 "flash_attention_fwd": k7},
                    f"(e) {arch}: the card's prefill launched {launched}")
        require(ex <= 1.0, f"(e) {arch}: card and host prefill logits "
                           f"disagree: {ex}")
        require(same_routes, f"(e) {arch}: the card routes differently")
        require((out_host == out_card).all(),
                f"(e) {arch}: greedy tokens differ: {out_host} vs "
                f"{out_card}")


def run_family_phase():
    """Phase 13: (a) deepseek-v2-lite-16b and (b) phi-3-vision-4.2b served
    at full width and depth, (c) granite-moe-1b-a400m and (d)
    phi-3-vision trained at full width on 2 cuda_ipc ranks (depth cut),
    (e) the reduced float32 specs card against host."""
    import torch
    t0 = time.perf_counter()

    def free():
        if torch.device(SERVE_DEVICE).type == "cuda":
            torch.cuda.empty_cache()

    rec = {"a": serve_family(DSV2, DSV2_PROMPT, "(a)")}
    free()
    rec["b"] = serve_family(PHI3, PHI3_TEXT, "(b)")
    free()
    rec["c"] = family_train(GRANITE_MOE, GRANITE_MOE_LAYERS, LONG_SEQ, "(c)")
    rec["d"] = family_train(PHI3, PHI3_TRAIN_LAYERS, PHI3_TEXT, "(d)")
    family_card_vs_host()
    free()
    log(f"  phase 13 {time.perf_counter() - t0:.1f} s on {gpu_line()}")
    return rec


# ---------------------------------------------------------------------------
# phase 14: the recurrent and encoder-decoder families, and remat
# ---------------------------------------------------------------------------

ZAMBA2, XLSTM, WHISPER = "zamba2-1.2b", "xlstm-350m", "whisper-tiny"
RECURRENT_PARAMS = {ZAMBA2: 1_113_328_512, XLSTM: 313_119_828,
                    WHISPER: 36_487_680}
RECURRENT_NEW = 32
# (a)-(c): prompt and decode-against-forward (prefill, teacher-forced
# steps); zamba2's lengths are multiples of its ssm_chunk of 256
RECURRENT_SERVE = {ZAMBA2: (4096, 3840, 256), XLSTM: (512, 256, 8),
                   WHISPER: (64, 64, 8)}
XLSTM_CHUNK = 64                   # (b) the chunked check; (d) training
XLSTM_PROFILED = 64                # (b) the prefill profiled
XLSTM_SHORT = (8, 4)               # (b) float32 decode = forward: the
                                   # reference test's prefill and steps
RECURRENT_TRAIN_SEQ = 4096         # (d)
XLSTM_TRAIN_SEQ = 1024             # (d) cut: its time loops took 22-27 s
                                   # a step at 4096 and 11.8-17.1 at 2048,
                                   # phase 14 over its 180 s at both
XLSTM_TRAIN_LAYERS = 8             # (d) cut: depth, one group of 8 (7
                                   # mLSTM + 1 sLSTM); 24 took 50.6 s
ZAMBA2_TRAIN_LAYERS = 12           # (d) cut: depth, whole groups of 6
RECURRENT_SMALL_PROMPT = 96        # (e): a multiple of the reduced chunk
RECURRENT_WIDTHS = (1024, 2048, 4096)   # K6 rows in phase 14 (phase 2)


def _recurrent_forward(params, spec, toks, extra):
    """The full forward's logits over ``toks`` (with whisper's frames)."""
    from repro_torch.models import encdec, hybrid, ssm_lm
    if spec.family == "hybrid":
        return hybrid.forward(params, toks, spec)
    if spec.family == "ssm":
        return ssm_lm.forward(params, toks, spec)[0]
    enc = encdec.encode(params, extra["frames"], spec)
    return encdec.decoder_forward(params, toks, enc, spec)


def _recurrent_kernels(spec, positions):
    """K6 and K7 launches per forward of ``positions`` tokens: K6 on
    every RMSNorm (zamba2: each Mamba2 layer, two in each application of
    the shared block, the final norm; xLSTM: each block and the final;
    whisper: LayerNorm, none), K7 in each shared-block application or
    decoder self-attention above ``attn_full_seq_max``."""
    flash = positions > spec.attn_full_seq_max
    if spec.family == "hybrid":
        apps = spec.num_layers // spec.attn_every
        return {"fused_rmsnorm": spec.num_layers + 2 * apps + 1,
                "flash_attention_fwd": apps if flash else 0}
    if spec.family == "ssm":
        return {"fused_rmsnorm": spec.num_layers + 1,
                "flash_attention_fwd": 0}
    return {"fused_rmsnorm": 0,
            "flash_attention_fwd": spec.num_layers if flash else 0}


def _recurrent_parity(params, spec, toks, extra, prompt, profile):
    """``(got, want, profiled)``: prefill ``prompt`` of ``toks``,
    teacher-force the rest (the last step profiled when ``profile``);
    ``got`` its logits, ``want`` the forward's over all at the last
    position (f32)."""
    import torch
    from repro_torch.models import build_model
    model = build_model(spec)
    n_all = toks.shape[1]
    last = n_all - 1
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks[:, :prompt],
                                          **extra}, n_all)
        for t in range(prompt, last):
            got, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        prof = _profiled(lambda: model.decode_step(
            params, cache, toks[:, last:last + 1]), profile)
        got, cache = prof.pop("out")
        del cache
        _release(toks.is_cuda)
        want = _recurrent_forward(params, spec, toks, extra)[:, -1].float()
    return got.float(), want, prof


def _xlstm_checks(params, spec, toks, label):
    """(b)'s checks beside the served bf16 decode, on the served
    parameters.  At full depth with random weights the xLSTM amplifies
    rounding, in the reference as in the port (at 256 wide and 24
    layers the reference's own chunked and sequential forms are ~0.1
    apart in float32, 1e-6 at 2 layers:
    ``tests/test_torch_xlstm_depth.py::test_depth_amplifies_rounding_alike``).
    So the reference's criteria are held where rounding is not
    amplified: at full depth decode = forward in float32 on the
    reference test's short prompt (``XLSTM_SHORT``: prefill 8, 4
    teacher-forced steps); at full width cut to its first mLSTM and
    first sLSTM layer (``slstm_every`` 2), decode = forward in bf16
    within 0.05 over ``toks`` and, in float32, the chunked prefill
    (``mlstm_chunk`` 64) against the sequential one (logits within 1e-3,
    the next decode step from each state within 2e-4); on one mLSTM
    layer the chunked form against the sequential scan (the reference's
    ``test_chunked_state_handoff``: outputs within 2e-4, states within
    1e-4, the next decode step from each state within 2e-4).  The whole
    model's chunked prefill against its sequential one is printed."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.models import build_model, xlstm
    spec32 = dataclasses.replace(spec, dtype="float32")
    chunked = dataclasses.replace(spec32, mlstm_chunk=XLSTM_CHUNK)
    t0 = time.perf_counter()
    prefill, steps = XLSTM_SHORT
    got, want, _ = _recurrent_parity(params, spec32,
                                     toks[:, :prefill + steps], {}, prefill,
                                     False)
    rel32 = _rel(got, want)
    log(f"  {label} decode = forward (float32): prefill {prefill}, {steps} "
        f"teacher-forced steps: rel err {rel32:.4e} (required < 0.05)")
    require(rel32 < 0.05, f"{label} float32 decode differs from forward: "
                          f"rel {rel32}")

    # Full width, two layers: the served first mLSTM and first sLSTM.
    two = dataclasses.replace(spec, num_layers=2, slstm_every=2)
    p2 = {"embed": params["embed"], "ln_f": params["ln_f"],
          **{k: tree.tree_map(lambda w: w[:1], params[k])
             for k in ("mlstm", "slstm")}}
    n_steps = RECURRENT_SERVE[XLSTM][2]
    n_prompt = toks.shape[1] - 1 - n_steps
    got, want, _ = _recurrent_parity(p2, two, toks[:, :-1], {}, n_prompt,
                                     False)
    rel2 = _rel(got, want)
    two32 = dataclasses.replace(two, dtype="float32")
    two_chk = dataclasses.replace(two32, mlstm_chunk=XLSTM_CHUNK)
    with torch.inference_mode():
        runs = []
        for sp in (two32, two_chk):
            m = build_model(sp)
            lg, cache = m.prefill(p2, {"tokens": toks[:, :-1]},
                                  toks.shape[1])
            nxt, _ = m.decode_step(p2, cache, toks[:, -1:])
            runs.append((lg.float(), nxt.float()))
    pre2, nxt2 = (_rel(c, q) for c, q in zip(runs[1], runs[0]))
    log(f"  {label} full width, {two.num_layers} layers (mLSTM, sLSTM): "
        f"decode = forward ({spec.dtype}): prefill {n_prompt}, "
        f"{n_steps} teacher-forced steps: rel err {rel2:.4e} "
        f"(required < 0.05); float32 mlstm_chunk {XLSTM_CHUNK} against the "
        f"sequential scan over {toks.shape[1] - 1} tokens: prefill logits "
        f"rel {pre2:.4e} (required <= 1e-3), the next decode step rel "
        f"{nxt2:.4e} (required <= 2e-4)")
    require(rel2 < 0.05, f"{label} two-layer bf16 decode differs from "
                         f"forward: rel {rel2}")
    require(pre2 <= 1e-3 and nxt2 <= 2e-4,
            f"{label} two-layer chunked prefill differs from the "
            f"sequential one: {pre2}, {nxt2}")

    gen = torch.Generator(device=toks.device).manual_seed(4)
    x = torch.randn((SERVE_BATCH, toks.shape[1] - 1, spec.d_model),
                    generator=gen, device=toks.device)
    x2 = torch.randn((SERVE_BATCH, 1, spec.d_model), generator=gen,
                     device=toks.device)
    lp = {k: v[0] for k, v in params["mlstm"]["mixer"].items()}
    with torch.inference_mode():
        y_seq, st_seq = xlstm.mlstm_forward(lp, x, spec32)
        y_chk, st_chk = xlstm.mlstm_forward(lp, x, chunked)
        d_seq, _ = xlstm.mlstm_decode(lp, x2, st_seq, spec32)
        d_chk, _ = xlstm.mlstm_decode(lp, x2, st_chk, spec32)
        full_seq, _ = build_model(spec32).prefill(params,
                                                  {"tokens": toks[:, :-1]})
        full_chk, _ = build_model(chunked).prefill(params,
                                                   {"tokens": toks[:, :-1]})
    y_ex = _excess(y_chk, y_seq, 2e-4, 2e-4)
    st_ex = max(_excess(st_chk[k], st_seq[k], 1e-4, 1e-4) for k in st_seq)
    d_ex = _excess(d_chk, d_seq, 2e-4, 2e-4)
    full_rel = _rel(full_chk.float(), full_seq.float())
    log(f"  {label} one mLSTM layer at full width, {x.shape[1]} tokens, "
        f"mlstm_chunk {XLSTM_CHUNK} against the sequential scan (float32): "
        f"max err/tol outputs {y_ex:.3f} (2e-4), states {st_ex:.3f} (1e-4), "
        f"the next decode step from each state {d_ex:.3f} (2e-4); the whole "
        f"model's prefill logits rel {full_rel:.3e} (printed: rounding "
        f"amplified over {spec.num_layers} layers); "
        f"{time.perf_counter() - t0:.1f} s")
    require(max(y_ex, st_ex, d_ex) <= 1.0,
            f"{label} chunked mLSTM differs from the sequential scan: "
            f"{y_ex}, {st_ex}, {d_ex}")
    return {"f32_rel": rel32, "two_layer": (rel2, pre2, nxt2),
            "layer_excess": (y_ex, st_ex, d_ex),
            "full_chunked_rel": full_rel}


def serve_recurrent(arch, label):
    """(a)-(c): ``arch`` as published, full width and depth, served in
    this process through ``build_engine`` and ``ServeEngine``: batch 2,
    the prompt of ``RECURRENT_SERVE``, 32 greedy tokens.  K6 and K7 per
    forward as :func:`_recurrent_kernels` says (never K7 in decode),
    tokens in range before the lookup, decode logits finite; decode
    against forward in bf16 within 0.05 (xLSTM: its bf16 decode no
    farther from the float32 forward than ``DECODE_FAITH`` times the bf16
    forward, then :func:`_xlstm_checks`); the card at most 90% full.
    Returns the record."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_spec
    from repro_torch.core.hw import H100_SXM
    from repro_torch.data.synthetic import SyntheticText
    from repro_torch.launch.serve import build_engine, decode_ms

    spec = get_spec(arch)
    prompt, par_prompt, par_steps = RECURRENT_SERVE[arch]
    cuda = torch.device(SERVE_DEVICE).type == "cuda"
    args = serve_args(arch=arch, full=True, batch=SERVE_BATCH,
                      prompt_len=prompt, new_tokens=RECURRENT_NEW,
                      device=SERVE_DEVICE)
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, batch = build_engine(args, spec=spec)
    _sync(SERVE_DEVICE)
    init_s = time.perf_counter() - t0
    _release(cuda)
    n_params = sum(t.numel() for t in tree.leaves(engine.params))
    extra = {k: v.to(SERVE_DEVICE) for k, v in batch.items()
             if k != "tokens"}
    frames = f", frames {tuple(extra['frames'].shape)}" if extra else ""
    log(f"  {label} {spec.name} ({spec.family}): {spec.num_layers} layers, "
        f"d_model {spec.d_model}, vocab {spec.vocab_size}, {spec.dtype} "
        f"compute; {n_params} f32 parameters drawn on the card in "
        f"{init_s:.1f} s; batch {SERVE_BATCH}, prompt {prompt}{frames}, "
        f"{RECURRENT_NEW} greedy tokens, max_seq {engine.cfg.max_seq}")
    require(n_params == RECURRENT_PARAMS[arch],
            f"{label} {arch} has {n_params} parameters, not "
            f"{RECURRENT_PARAMS[arch]}")
    require(engine.cfg.max_seq == prompt + RECURRENT_NEW + 1,
            f"{label} max_seq {engine.cfg.max_seq} is not the text's")
    calls, finite, checked = [], [None], []
    engine.model = _count_calls(_token_check(engine.model, checked), calls,
                                finite)
    _reset_counts()                           # main path starts here
    out = engine.generate(batch)
    totals = _counts()                        # main path ends here
    scalar = _scalar_counts()
    require(checked and not any(int(h) for h in checked),
            f"{label} out-of-range prompt tokens on the card: "
            f"{[int(h) for h in checked]}")
    kinds = [kind for kind, _ in calls]
    require(kinds == ["prefill"] + ["decode"] * RECURRENT_NEW,
            f"{label} ran {kinds}")
    if cuda:
        for i, (kind, got) in enumerate(calls):
            want = _recurrent_kernels(spec, prompt if kind == "prefill"
                                      else 1)
            require(got == want, f"{label} call {i} ({kind}) launched "
                                 f"{got}, not {want}")
    require(out.shape == (SERVE_BATCH, RECURRENT_NEW)
            and out.min() >= 0 and out.max() < spec.padded_vocab,
            f"{label} tokens out of [0, {spec.padded_vocab}): {out}")
    require(bool(finite[0]), f"{label} non-finite decode logits")
    timing = engine.timing
    dec_ms = decode_ms(timing)
    total_s = timing["prefill_s"] + sum(timing["decode_s"])
    cache_bytes = _cache_bytes(engine.model, SERVE_BATCH, engine.cfg.max_seq)
    bw = H100_SXM.hbm_bandwidth
    floor = (n_params * FLOOR_BYTES_PER_PARAM + cache_bytes) / bw * 1e3
    log(f"  {label} launches per forward: prefill {calls[0][1]}, decode "
        f"{calls[1][1]} (x{RECURRENT_NEW}); tokens row 0 "
        f"{out[0][:12].tolist()}")
    log(f"  {label} prefill {timing['prefill_s']:.4f} s; decode "
        f"{dec_ms:.3f} ms/token (median of steps 2-{RECURRENT_NEW}); "
        f"{SERVE_BATCH * RECURRENT_NEW / total_s:.1f} tokens/s over the "
        f"generation; decode floor (f32 weights read once, {n_params} x "
        f"{FLOOR_BYTES_PER_PARAM} B, plus the cache and states, "
        f"{cache_bytes} B, over {bw / 1e12:.2f} TB/s) {floor:.3f} ms, "
        f"measured/floor {dec_ms / floor:.1f}")

    # Decode against forward, the reference's criterion, in bf16.
    toks = SyntheticText(spec.vocab_size, batch=SERVE_BATCH,
                         seq_len=par_prompt + par_steps,
                         seed=1).batch_at(0)["tokens"].to(SERVE_DEVICE)
    _release(cuda)
    t1 = time.perf_counter()
    got, want, busy = _recurrent_parity(engine.params, spec, toks, extra,
                                        par_prompt, cuda)
    rel = _rel(got, want)
    # xLSTM at full depth amplifies rounding (_xlstm_checks): its bf16
    # decode is held, as phase 13 holds deepseek-v2-lite's, no farther
    # from the float32 forward than DECODE_FAITH times the bf16 forward.
    held = spec.family != "ssm"
    log(f"  {label} decode = forward ({spec.dtype}): prefill {par_prompt}, "
        f"{par_steps} teacher-forced steps, last logits against forward "
        f"over {par_prompt + par_steps} tokens: rel err {rel:.4e} "
        f"({'required < 0.05' if held else 'printed'}) in "
        f"{time.perf_counter() - t1:.1f} s")
    rec = {"totals": totals, "scalar": scalar,
           "prefill_s": timing["prefill_s"], "decode_ms": dec_ms,
           "floor_ms": floor, "rel": rel, "n_params": n_params}
    if held:
        require(rel < 0.05, f"{label} decode differs from forward: rel "
                            f"{rel}")
    else:
        _release(cuda)
        with torch.inference_mode():
            want32 = _recurrent_forward(
                engine.params, dataclasses.replace(spec, dtype="float32"),
                toks, extra)[:, -1].float()
        dec_err, fwd_err = _rel(got, want32), _rel(want, want32)
        log(f"  {label} against the float32 forward's last logits: bf16 "
            f"decode rel {dec_err:.4e}, bf16 forward rel {fwd_err:.4e} "
            f"(decode/forward {dec_err / fwd_err:.3f}, required <= "
            f"{DECODE_FAITH})")
        require(dec_err <= DECODE_FAITH * fwd_err,
                f"{label} the bf16 decode is {dec_err} from the float32 "
                f"forward, the bf16 forward {fwd_err}")
        rec["decode_over_forward"] = dec_err / fwd_err
    if spec.family == "ssm":
        _release(cuda)
        rec["xlstm"] = _xlstm_checks(engine.params, spec,
                                     toks[:, :par_prompt + 1], label)
        if cuda:
            # The sequential prefill's cost: its launches, from a short
            # prompt profiled (the 512-token one would hold ~3x10^5 events).
            with torch.inference_mode():
                pre = _profiled(lambda: engine.model.prefill(
                    engine.params, {"tokens": toks[:, :XLSTM_PROFILED]}),
                    cuda)
            per = pre["kernels"] / XLSTM_PROFILED
            log(f"  {label} a {XLSTM_PROFILED}-token prefill profiled: "
                f"{pre['kernels']} kernels ({per:.1f} a token, so ~"
                f"{per * prompt:.0f} in the {prompt}-token prefill), card "
                f"busy {pre['device_ms']:.2f} ms of {pre['wall_ms']:.2f} ms "
                f"host wall ({pre['device_ms'] / pre['wall_ms']:.1%})")
            rec["prefill_kernels_per_token"] = per
    if cuda:
        log(f"  {label} one decode step profiled: {busy['kernels']} "
            f"kernels, card busy {busy['device_ms']:.2f} ms of "
            f"{busy['wall_ms']:.2f} ms host wall "
            f"({busy['device_ms'] / busy['wall_ms']:.1%}); the profiler "
            f"slows the host")
        card, released = _card_in_use_gib(1)
        held = card + released
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {label} the card in use at its peak {held:.2f} of "
            f"{total:.2f} GiB ({held / total:.1%}); peak allocated "
            f"{peak:.2f} GiB")
        require(held <= 0.9 * total,
                f"{label} holds {held:.2f} GiB of the card, more than 90%")
        rec.update(held_gib=held, peak_gib=peak,
                   kernels_per_step=busy["kernels"])
    log(f"  {label} {time.perf_counter() - t_phase:.1f} s")
    return rec


def recurrent_train(arch, label, layers=None, overrides=None,
                    seq=RECURRENT_TRAIN_SEQ):
    """(d): ``arch`` at full width (depth cut to ``layers`` when given,
    the spec changed by ``overrides``), trained on 2 ``cuda_ipc`` ranks
    sharing the card through ``run_phase`` (``rhd_rsa`` + ``int8`` fused
    hops, K5 AdamW, batch 1 per rank, ``seq`` tokens, 2 steps): K7 and K8 once per attention per step (zamba2's shared-block
    applications, whisper's decoder layers; none in xLSTM), the card at
    most 90% full; then the reduced float32 spec on the card and on the
    host.  Returns each rank's record."""
    import dataclasses
    import torch
    from repro_torch.configs import get_spec
    t0 = time.perf_counter()
    full = get_spec(arch)
    spec = dataclasses.replace(full, num_layers=layers or full.num_layers,
                               **(overrides or {}))
    small_spec = dataclasses.replace(full.reduced(), dtype="float32")
    if spec.family == "ssm":
        small_spec = dataclasses.replace(small_spec, mlstm_chunk=16)
    cuts = []
    if spec.num_layers != full.num_layers:
        cuts.append(f"depth, {spec.num_layers} of {full.num_layers} layers")
    if seq != RECURRENT_TRAIN_SEQ:
        cuts.append(f"sequence, {seq} of {RECURRENT_TRAIN_SEQ}")
    log(f"  {label} {arch} at full width (d_model {spec.d_model}); cut: "
        f"{'; '.join(cuts) or 'none'}; deviations from the published spec: "
        f"{overrides or 'none'}; seq {seq}")
    attn = {"hybrid": spec.num_layers // max(spec.attn_every, 1),
            "ssm": 0, "audio": spec.num_layers}[spec.family]
    required = ["hop_absmax", "hop_encode", "hop_decode_add", "adamw_update"]
    if spec.norm_type == "rmsnorm":
        required.append("fused_rmsnorm")
    if attn:
        required += ["flash_attention_fwd", "flash_attention_bwd"]
    args = train_args(arch=arch, full=True, batch=LONG_WORLD, seq=seq,
                      steps=LONG_STEPS, device="cuda")
    small = train_args(arch=arch, full=False, batch=2 * LONG_WORLD,
                       seq=RECURRENT_SMALL_PROMPT, steps=2, dtype="float32")
    results = run_phase(LONG_WORLD, args, small, tuple(required), spec=spec,
                        small_spec=small_spec, backend="cuda_ipc")
    for r in results:
        for s_, rec in enumerate(r["steps"], 1):
            for k in ("flash_attention_fwd", "flash_attention_bwd"):
                require(rec["launches"][k] == attn,
                        f"{label} rank {r['rank']} step {s_}: {k} launched "
                        f"{rec['launches'][k]} times, not {attn}")
    for s_, rec in enumerate(results[0]["steps"], 1):
        log(f"  {label} step {s_}: ce {rec['ce']:.5f} step_s "
            f"{rec['step_s']:.3f}; launches {rec['launches']}")
    log(f"  {label} the aggregate timed alone per rank "
        f"{[round(r['breakdown']['aggregate_s'], 4) for r in results]} s; "
        f"{time.perf_counter() - t0:.1f} s")
    if args.device != "cuda":
        return results
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    held = max(r["card_gib"] for r in results) + sum(
        r["released_gib"] for r in results)
    log(f"  {label} the card in use at its peak {held:.2f} of {total:.2f} "
        f"GiB ({held / total:.1%}); GiB allocated at peak per rank "
        f"{[round(r['peak_gib'], 2) for r in results]}")
    require(held <= 0.9 * total,
            f"{label} holds {held:.2f} GiB of the card, more than 90%: cut "
            f"its layers")
    return results


def recurrent_card_vs_host():
    """(e): the reduced float32 specs of the three at prompt 96 (a
    multiple of the reduced ssm_chunk, above the reduced
    attn_full_seq_max of 64) on the card and on the host's plain versions
    from the same parameters: prefill logits within K7's f32 tolerance,
    16 greedy tokens equal."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_spec
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    for arch in (ZAMBA2, XLSTM, WHISPER):
        spec = dataclasses.replace(get_spec(arch).reduced(), dtype="float32")
        args = serve_args(arch=arch, full=False, batch=SERVE_BATCH,
                          prompt_len=RECURRENT_SMALL_PROMPT,
                          new_tokens=SMALL_NEW, device="cpu")
        host, batch = build_engine(args, spec=spec)
        card = ServeEngine(host.model, tree.tree_map(
            lambda t: t.detach().to(SERVE_DEVICE), host.params), None,
            host.cfg, SERVE_DEVICE)
        model = host.model
        on_card = {k: v.to(SERVE_DEVICE) for k, v in batch.items()}
        with torch.inference_mode():
            want, _ = model.prefill(host.params, batch, host.cfg.max_seq)
            before = _counts()
            got, _ = model.prefill(card.params, on_card, host.cfg.max_seq)
            after = _counts()
        launched = {k: after[k] - before[k] for k in SERVE_KERNELS}
        ex = _excess(got.cpu(), want, 2e-5, 1e-4)
        out_host, out_card = host.generate(batch), card.generate(batch)
        log(f"  (e) float32 {spec.name} ({spec.num_layers} layers, d_model "
            f"{spec.d_model}), prompt {RECURRENT_SMALL_PROMPT}: prefill "
            f"launched {launched} on the card; prefill logits max err/tol "
            f"{ex:.3f} (K7's f32 tolerance atol 2e-5 / rtol 1e-4); "
            f"{SMALL_NEW} greedy tokens equal: "
            f"{bool((out_host == out_card).all())}")
        if torch.device(SERVE_DEVICE).type == "cuda":
            require(launched == _recurrent_kernels(
                spec, RECURRENT_SMALL_PROMPT),
                f"(e) {arch}: the card's prefill launched {launched}")
        require(ex <= 1.0, f"(e) {arch}: card and host prefill logits "
                           f"disagree: {ex}")
        require((out_host == out_card).all(),
                f"(e) {arch}: greedy tokens differ: {out_host} vs "
                f"{out_card}")
    log(f"  (e) {time.perf_counter() - t0:.1f} s")


def remat_train(phase4=None):
    """(f): phase 4's run (full-width smollm-360m, seq 4096, 2 gloo
    ranks, 2 steps, the same seed) with ``remat=True``: each block's
    activations recomputed in the backward, so K7 runs twice per layer
    per step and K8 once.  The parameters after 2 steps must equal phase
    4's bit for bit (``phase4``; run here first when not given), and the
    two runs' peak memory is printed."""
    import dataclasses
    from repro_torch.configs import get_spec
    t0 = time.perf_counter()
    args = train_args(full=True, batch=LONG_WORLD, seq=LONG_SEQ,
                      steps=LONG_STEPS, device="cuda")
    small = train_args(full=False, batch=2 * LONG_WORLD, seq=128, steps=2,
                       dtype="float32")
    required = tuple(k for k in KERNELS if k != "fused_reduce")
    if phase4 is None:
        log("  (f) phase 4's run, remat off")
        phase4 = run_phase(LONG_WORLD, args, small, required)
    spec = dataclasses.replace(get_spec("smollm-360m"), remat=True)
    small_spec = dataclasses.replace(get_spec("smollm-360m").reduced(),
                                     dtype="float32", remat=True)
    log("  (f) remat=True")
    results = run_phase(LONG_WORLD, args, small, required, spec=spec,
                        small_spec=small_spec)
    for r in results:
        for s_, rec in enumerate(r["steps"], 1):
            got = (rec["launches"]["flash_attention_fwd"],
                   rec["launches"]["flash_attention_bwd"])
            require(got == (2 * LAYERS, LAYERS),
                    f"(f) rank {r['rank']} step {s_}: K7/K8 launched {got}, "
                    f"not {(2 * LAYERS, LAYERS)}")
    same = {r["checksum"] for r in results} == {r["checksum"]
                                                for r in phase4}
    log(f"  (f) parameters after {LONG_STEPS} steps bit for bit phase 4's: "
        f"{same} (checksums {results[0]['checksum']} / "
        f"{phase4[0]['checksum']}); GiB allocated at peak per rank: remat "
        f"{[round(r['peak_gib'], 2) for r in results]}, phase 4 "
        f"{[round(r['peak_gib'], 2) for r in phase4]}; step_s remat "
        f"{[round(rec['step_s'], 3) for rec in results[0]['steps']]}, "
        f"phase 4 {[round(rec['step_s'], 3) for rec in phase4[0]['steps']]}"
        f"; {time.perf_counter() - t0:.1f} s")
    require(same, "(f) remat changed the parameters")
    return results


def run_recurrent_phase(phase4=None):
    """Phase 14: (a) zamba2-1.2b, (b) xlstm-350m and (c) whisper-tiny
    served at full width and depth; (d) the three trained on 2 cuda_ipc
    ranks; (e) the reduced float32 specs card against host; (f) remat
    against phase 4."""
    import torch
    t0 = time.perf_counter()
    rec = {}
    for arch, label in ((ZAMBA2, "(a)"), (XLSTM, "(b)"), (WHISPER, "(c)")):
        rec[label] = serve_recurrent(arch, label)
        torch.cuda.empty_cache()
    rec["d"] = (recurrent_train(ZAMBA2, "(d) zamba2", ZAMBA2_TRAIN_LAYERS)
                + recurrent_train(XLSTM, "(d) xlstm", XLSTM_TRAIN_LAYERS,
                                  overrides={"mlstm_chunk": XLSTM_CHUNK},
                                  seq=XLSTM_TRAIN_SEQ)
                + recurrent_train(WHISPER, "(d) whisper"))
    recurrent_card_vs_host()
    torch.cuda.empty_cache()
    rec["f"] = remat_train(phase4)
    log(f"  phase 14 {time.perf_counter() - t0:.1f} s on {gpu_line()}")
    return rec


# ---------------------------------------------------------------------------
# phase 15: analysis/ and the planning tools
# ---------------------------------------------------------------------------

ANALYSIS_BUDGET_S = 60.0
ANALYSIS_CELLS = 157
DRYRUN_RECORDS = 80              # 10 archs x 4 shapes x 2 meshes


def _gib(n):
    return n / 2 ** 30


def _dryrun_records():
    """``dryrun --all`` on both meshes, and its seconds.  Host only (meta
    tensors), so the full run starts it in a process of its own beside
    phases 12-14."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = [r for mp in (False, True)
            for r in dryrun.run_all(mp, verbose=False)]
    return recs, time.perf_counter() - t0


def _dryrun_phase(pending=None):
    """(c) ``dryrun --all`` on both meshes (``pending``'s result, a
    future of :func:`_dryrun_records`, or run here): every record OK or
    SKIP with the shape policy's reason, every train record statically
    verified, ``report.py`` rendering them."""
    from repro_torch.configs import get_spec, shape_supported
    from repro_torch.core.hw import H100_SXM
    from repro_torch.launch import report
    ran = "in this process" if pending is None else "in a process of its own"
    recs, seconds = (_dryrun_records() if pending is None
                     else pending.result())
    require(len(recs) == DRYRUN_RECORDS,
            f"dryrun --all wrote {len(recs)} records, not {DRYRUN_RECORDS}")
    for r in recs:
        where = f"{r['arch']} x {r['shape']} x {r['mesh']}"
        ok, why = shape_supported(get_spec(r["arch"]), r["shape"])
        if ok:
            require(r["status"] == "OK",
                    f"{where}: {r['status']} {r.get('error', '')}")
            require(r["roofline"]["chip"] == H100_SXM.name,
                    f"{where}: priced on {r['roofline']['chip']}")
            if r["shape"] == "train_4k":
                require(r.get("verified_static") is True,
                        f"{where}: not statically verified "
                        f"{r.get('analysis', {}).get('diagnostics')}")
        else:
            require(r["status"] == "SKIP" and r["reason"] == why,
                    f"{where}: {r['status']} {r.get('reason')}")
    md = [report.dryrun_matrix(recs, m) for m in ("16x16", "2x16x16")]
    md += [report.skips(recs), report.roofline_table(recs),
           report.schedule_table(recs)]
    require(all(md[:2]) and "OK" in md[0], "report.py rendered nothing")
    counts = collections.Counter(r["status"] for r in recs)
    fits = collections.Counter(
        (r["mesh"], r["memory_estimate"]["fits"]) for r in recs
        if r["status"] == "OK")
    log(f"  (c) dryrun --all, 16x16 and 2x16x16, {ran}: "
        f"{len(recs)} records ({dict(counts)}) in {seconds:.1f} s; every "
        f"train record verified_static; priced on {H100_SXM.name}; "
        f"fits the card's {H100_SXM.hbm_bytes / 1e9:.0f} GB by mesh "
        f"{dict(fits)}; report.py renders {sum(len(m) for m in md)} "
        f"characters")
    for r in recs:
        if r["status"] != "OK" or r["mesh"] != "16x16":
            continue
        rf, mem = r["roofline"], r["memory_estimate"]
        log(f"      {r['arch']:22s} {r['shape']:12s} rows {r['rows_per_rank']:3d}"
            f" memory {_gib(mem['total_bytes']):9.2f} GiB (exact "
            f"{_gib(mem['exact_bytes']):7.2f}) compute "
            f"{rf['compute_s'] * 1e3:10.2f} ms memory "
            f"{rf['memory_s'] * 1e3:10.2f} ms collective "
            f"{rf['collective_s'] * 1e3:8.2f} ms {rf['dominant']}")
    return recs, seconds


def _estimate(label, spec, world, rows, seq):
    """(d) the dry run's memory estimate and roofline at a phase's own
    configuration: ``rhd_rsa`` + ``int8`` over ``world`` ranks, one data
    axis, ``rows`` rows a rank."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    rec = dryrun.plan_step(spec, InputShape(label, seq, rows * world,
                                            "train"), {"data": world},
                           codec="int8")
    rf = rec["roofline"]
    return {"label": label, "memory": rec["memory_estimate"],
            "roofline": rf, "step_s": max(rf["compute_s"], rf["memory_s"])
            + rf["collective_s"]}


def _estimates_vs_measured(phase3, phase4, phase6, phase11):
    """(d) Estimate against measurement: the exact part (parameters,
    gradients, AdamW moments, inputs) at most each rank's measured peak;
    the full estimate's ratio to the peak, and the roofline beside the
    measured forward+backward, aggregate and step, printed."""
    import dataclasses
    from repro_torch.configs import get_spec
    smol = get_spec("smollm-360m")
    gemma = dataclasses.replace(get_spec("gemma-7b"),
                                num_layers=GEMMA_LAYERS)
    cases = []
    if phase3 is not None:
        cases += [(f"phase 3: smollm-360m seq 512, {TRAIN_WORLD} ranks",
                   smol, TRAIN_WORLD, 2, 512, phase3),
                  (f"phase 4: smollm-360m seq {LONG_SEQ}, {LONG_WORLD} "
                   f"ranks", smol, LONG_WORLD, 1, LONG_SEQ, phase4),
                  (f"phase 6: gemma-7b {GEMMA_LAYERS} layer seq {LONG_SEQ},"
                   f" {GEMMA_WORLD} ranks", gemma, GEMMA_WORLD, 1,
                   LONG_SEQ, phase6)]
    else:
        cases += [(f"phase 11(a) (phase 3's configuration on cuda_ipc): "
                   f"smollm-360m seq 512, {TRAIN_WORLD} ranks", smol,
                   TRAIN_WORLD, 2, 512, None)]
    out = []
    for label, spec, world, rows, seq, results in cases:
        est = _estimate(label, spec, world, rows, seq)
        mem, rf = est["memory"], est["roofline"]
        if results is not None:
            peaks = [r["peak_gib"] for r in results]
            fb = min(r["breakdown"]["fwd_bwd_s"] for r in results)
            agg_s = min(r["breakdown"]["aggregate_s"] for r in results)
            steps = [st["step_s"] for st in results[0]["steps"][1:]]
        else:
            peaks = [r["lm"]["peak_gib"] for r in phase11]
            fb = None
            agg_s = min(st["aggregate_s"] for r in phase11
                        for st in r["lm"]["steps"][1:])
            steps = [st["train_step_s"] for st in phase11[0]["lm"]["steps"][1:]]
        step = sum(steps) / len(steps)
        require(_gib(mem["exact_bytes"]) <= min(peaks),
                f"{label}: the exact part {_gib(mem['exact_bytes']):.3f} GiB "
                f"exceeds a rank's measured peak {min(peaks):.3f} GiB")
        log(f"  (d) {label}: memory estimate {_gib(mem['total_bytes']):.3f} "
            f"GiB a rank = exact {_gib(mem['exact_bytes']):.3f} "
            f"({ {k: round(_gib(v), 3) for k, v in mem['exact'].items()} }) "
            f"+ activations {_gib(mem['activations_bytes']):.3f}; measured "
            f"peak allocated per rank {[round(p, 3) for p in peaks]} GiB: "
            f"exact/peak {_gib(mem['exact_bytes']) / max(max(peaks), 1e-9):.3f}"
            f", estimate/peak "
            f"{_gib(mem['total_bytes']) / max(max(peaks), 1e-9):.3f}")
        log(f"      roofline ({rf['chip']}): compute "
            f"{rf['compute_s'] * 1e3:.3f} ms, memory (eager aten bytes) "
            f"{rf['memory_s'] * 1e3:.3f} ms, collective over NVLink "
            f"{rf['collective_s'] * 1e3:.3f} ms (these ranks share one card: "
            f"their hops never cross NVLink), step estimate "
            f"{est['step_s'] * 1e3:.3f} ms; measured forward+backward "
            f"{'not measured' if fb is None else f'{fb * 1e3:.3f} ms'}, "
            f"aggregate {agg_s * 1e3:.3f} ms, step {step * 1e3:.3f} ms")
        out.append({**est, "peaks_gib": peaks, "fwd_bwd_s": fb,
                    "aggregate_s": agg_s, "measured_step_s": step})
    return out


def run_analysis_phase(phase3=None, phase4=None, phase6=None,
                       phase11=None, dryrun=None):
    """Phase 15: (a) the schedule and source gate, (b) phase 11's hop
    lint (summarised here), (c) the dry run on both meshes (``dryrun``,
    a future of its records, or run here), (d) the estimates against
    phases 3, 4 and 6 (phase 11's run alone under ``--analysis-only``).
    Returns its record."""
    from repro_torch.analysis import __main__ as analysis_cli
    t_start = time.perf_counter()
    # (a)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "analysis.json")
        rc = analysis_cli.main(["--source", "--schedules",
                                "--check-baseline", "--root", ROOT,
                                "--json", out, "-q"])
        with open(out) as f:
            summary = json.load(f)
    gate_s = time.perf_counter() - t0
    require(rc == 0 and summary["n_errors"] == 0,
            f"python -m repro_torch.analysis exited {rc}: "
            f"{summary['diagnostics'][:3]}")
    require(summary["n_cells"] == ANALYSIS_CELLS,
            f"{summary['n_cells']} schedule cells, not {ANALYSIS_CELLS}")
    require(summary["n_source_files"] > 0, "the import lint read no file")
    log(f"  (a) python -m repro_torch.analysis --source --schedules "
        f"--check-baseline: exit 0, {summary['n_cells']} schedule cells and "
        f"the import lint over {summary['n_source_files']} source files, "
        f"{summary['n_errors']} errors, "
        f"{summary['n_warnings']} warnings, in {gate_s:.2f} s")
    # (b)
    if phase11 is not None:
        n = sum(len(r[p]["steps"]) for r in phase11
                for p in ("lm", "cnn", "lm_overlap"))
        log(f"  (b) phase 11's spawn linted {n} rank-steps of full-width "
            f"smollm-360m (rhd_rsa + int8 fused hops, post-backward and "
            f"overlapped) and ResNet-50 (overlapped, HL002 checked): no "
            f"error, no unbaselined warning")
    # (c)
    recs, dry_s = _dryrun_phase(dryrun)
    # (d)
    t0 = time.perf_counter()
    estimates = _estimates_vs_measured(phase3, phase4, phase6, phase11)
    est_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_start
    log(f"  phase 15 {seconds:.1f} s ((a) {gate_s:.1f}, (c) {dry_s:.1f}, "
        f"(d) {est_s:.1f}; budget {ANALYSIS_BUDGET_S:.0f} s) on "
        f"{gpu_line()}")
    return {"gate_s": gate_s, "dryrun_s": dry_s, "estimates_s": est_s,
            "seconds": seconds, "records": len(recs),
            "estimates": estimates}


CHARACTERIZATION_BUDGET_S = 180.0
MEASURED_PS = (2, 4)
MEASURED_MODELS = ("resnet50", "mobilenet")
MEASURED_TRANSPORTS = ("cuda_ipc", "gloo")
MEASURED_REPS = 5
TRACE_ARCH = "smollm-360m"
TRACE_SHAPE = "train_4k"
CLOSURE_ARTIFACT = os.path.join(ROOT, "artifacts_torch",
                                "telemetry_closure.json")
# the same cells on 8 cuda_ipc ranks sharing the card: host-bound hops,
# out of the band (a record, not gated)
CLOSURE_CARD = os.path.join(ROOT, "artifacts_torch",
                            "telemetry_closure_card_cuda_ipc.json")


def _claims_check():
    """(a) ``python -m repro_torch.experiments.regen --check`` in this
    process: exit 0, C1-C10 all PASS."""
    from repro_torch.experiments import claims, regen
    rc = regen.main(["--check"])
    require(rc == 0, f"repro_torch.experiments.regen --check exited {rc}")
    rows = claims.evaluate()
    require(len(rows) == 10 and all(r["status"] == "PASS" for r in rows),
            f"claims not all PASS: {[(r['key'], r['status']) for r in rows]}")
    for r in rows:
        log(f"      {r['key']:36s} {r['value']:.4f} {r['units']:8s} "
            f"[{r['lo']:g}, {r['hi']:g}] {r['status']}")
    return rows


def _measured_backend():
    """(b) The paper's five designs on the port's reducers: ResNet-50
    and MobileNet-v1 at p = 2 and 4 ranks sharing the card, on cuda_ipc
    and gloo, every bucket size at full size, best of 5; each row's
    measured comm_s beside the paper profile's model comm_s, and whether
    every no-gRPC design beat gRPC_PS."""
    from repro_torch.experiments import matrix as mx
    points = [mx.ExperimentPoint(d, m, p) for m in MEASURED_MODELS
              for p in MEASURED_PS for d in mx.DESIGNS]
    t0 = time.perf_counter()
    rows = mx.measure_points(points, MEASURED_TRANSPORTS, reps=MEASURED_REPS,
                             scale=1.0, device="cuda")
    seconds = time.perf_counter() - t0
    require(len(rows) == len(points) * len(MEASURED_TRANSPORTS),
            f"{len(rows)} measured rows")
    model = {(pt.design, pt.model, pt.p): mx.run_point(pt) for pt in points}
    by = {}
    for transport, row in rows:
        key = (row["design"], row["model"], row["p"])
        lats = [b["predicted_s"] for b in row["schedule"]["buckets"]]
        sizes = sorted(int(b["bytes"]) for b in row["schedule"]["buckets"])
        require(row["backend"] == "measured"
                and sorted(row) == sorted(model[key])
                and sizes == mx.bucket_sizes(row["model"], row["design"])
                and all(math.isfinite(v) and v > 0 for v in lats),
                f"{transport} {key}: a bucket size without a finite, "
                f"positive latency ({sizes}, {lats})")
        by[(transport,) + key] = row
        m = model[key]
        log(f"      {transport:8s} {row['model']:9s} p={row['p']} "
            f"{row['design']:16s} {row['n_buckets']:3d} buckets: measured "
            f"comm {row['comm_s'] * 1e3:9.3f} ms (per bucket size "
            f"{', '.join(f'{b}: {v * 1e3:.3f}' for b, v in zip(sizes, lats))}"
            f" ms) | paper model {m['comm_s'] * 1e3:9.3f} ms")
    order = {}
    for transport in MEASURED_TRANSPORTS:
        for model_name in MEASURED_MODELS:
            for p in MEASURED_PS:
                ps = by[(transport, "gRPC_PS", model_name, p)]["comm_s"]
                beat = {d: by[(transport, d, model_name, p)]["comm_s"] < ps
                        for d in mx.DESIGNS if d != "gRPC_PS"}
                order[(transport, model_name, p)] = all(beat.values())
                log(f"      no-gRPC < gRPC_PS, {transport} {model_name} "
                    f"p={p}: {all(beat.values())} "
                    f"({ {d: round(ps / by[(transport, d, model_name, p)]['comm_s'], 2) for d in beat} } x)")
    log(f"  (b) {len(rows)} measured rows ({len(mx.DESIGNS)} designs x "
        f"{len(MEASURED_MODELS)} models x p {MEASURED_PS} x "
        f"{MEASURED_TRANSPORTS}) in {seconds:.1f} s, one spawn of "
        f"{max(MEASURED_PS)} ranks; no-gRPC < gRPC_PS in "
        f"{sum(order.values())} of {len(order)} cells (printed, not "
        f"required)")
    return {"rows": rows, "order": order, "seconds": seconds}


def _dryrun_traces():
    """(c) ``dryrun --trace`` on smollm-360m train_4k on 16x16."""
    from repro_torch.launch import dryrun, report
    arch = TRACE_ARCH
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        rec = dryrun.run_one(arch, TRACE_SHAPE, False, verbose=False,
                             trace_path=path, device="cuda")
        require(rec["status"] == "OK" and "calibration"
                in rec.get("measured", {}),
                f"dryrun --trace {arch}: {rec['status']} "
                f"{rec.get('error', '')} {rec.get('measured')}")
        with open(path) as f:
            n_spans = len(json.load(f)["traceEvents"])
    m, so = rec["measured"], rec["schedule"]
    mo, po = so["measured_overlap"], so["overlap"]
    log(f"  (c) dryrun --trace {arch} {TRACE_SHAPE} 16x16 "
        f"({time.perf_counter() - t0:.1f} s, {n_spans} trace events): "
        f"{m['n_stages']} stages ({m['n_gated']} gated), k "
        f"{m['calibration']['k']:.4g} (per axis size "
        f"{ {p: round(v['k'], 4) for p, v in m['calibration']['per_axis_size'].items()} }), "
        f"max_ratio {m['max_ratio']:.3f}, within_band "
        f"{m['all_within_band']}; overlap measured "
        f"{mo['overlap_fraction']:.4f} vs predicted "
        f"{po['overlap_fraction']:.4f} (exposed comm "
        f"{mo['exposed_comm_s'] * 1e3:.3f} vs "
        f"{po['timeline']['exposed_comm_s'] * 1e3:.3f} ms, model units)")
    seen = collections.Counter((r["op"], r["algorithm"], r["axis"],
                                r["axis_size"], r["n_bytes"])
                               for r in m["stages"])
    for r in m["stages"]:
        key = (r["op"], r["algorithm"], r["axis"], r["axis_size"],
               r["n_bytes"])
        if key not in seen or r["op"] == "shard":
            continue
        log(f"      x{seen.pop(key):2d} {r['op']:10s} {r['algorithm']:8s} "
            f"{r['axis']}@{r['axis_size']:2d} {r['n_bytes']:11d} B: "
            f"measured {r['measured_s'] * 1e3:8.3f} ms, predicted "
            f"{r['predicted_s'] * 1e6:8.2f} us, ratio {r['ratio']:.3f}"
            f"{'' if r['gated'] else ' (not gated)'}")
    rp = rec["trace_replay"]
    log(f"      replay on {rp['ranks']} ranks: estimate "
        f"{_gib(rp['estimate_bytes']):.2f} GiB a rank, peak reserved "
        f"{_gib(max(rp['peak_bytes'])):.2f} GiB (largest rank)")
    table = report.telemetry_table([rec])
    require(arch in table, "report.telemetry_table rendered nothing")
    log(table)
    return [rec]


def run_characterization_phase():
    """Phase 16: (a) regen --check and the claims, (b) the measured
    backend on the card, (c) dryrun --trace, (d) the committed closure
    artifact's --check.  Returns its record."""
    from repro_torch.telemetry import closure
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    claims = _claims_check()
    a_s = time.perf_counter() - t0
    log(f"  (a) python -m repro_torch.experiments.regen --check: exit 0, "
        f"C1-C10 all PASS ({a_s:.1f} s)")
    measured = _measured_backend()
    t0 = time.perf_counter()
    traces = _dryrun_traces()
    c_s = time.perf_counter() - t0
    rc = closure.main(["--check", CLOSURE_ARTIFACT])
    require(rc == 0, f"closure --check {CLOSURE_ARTIFACT} exited {rc}")
    with open(CLOSURE_ARTIFACT) as f:
        platform = json.load(f)["platform"]
    log(f"  (d) python -m repro_torch.telemetry.closure --check "
        f"artifacts_torch/telemetry_closure.json: exit 0 ({platform})")
    with open(CLOSURE_CARD) as f:
        card = json.load(f)
    log(f"      {os.path.basename(CLOSURE_CARD)} ({card['platform']}), "
        f"printed, not required: max_ratio "
        f"{ {c['name']: round(c['max_ratio'], 3) for c in card['cells']} }"
        f" against the band's {closure.BAND_FACTOR:g}; --check finds "
        f"{len(closure.check_artifact(CLOSURE_CARD))} problems")
    seconds = time.perf_counter() - t_start
    log(f"  phase 16 {seconds:.1f} s ((a) {a_s:.1f}, (b) "
        f"{measured['seconds']:.1f}, (c) {c_s:.1f}; budget "
        f"{CHARACTERIZATION_BUDGET_S:.0f} s) on {gpu_line()}")
    return {"claims": claims, "measured": measured, "traces": traces,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 17: seq_parallel and overlap on the model axis, K7/K8 with a
# query offset, F9's measure
# ---------------------------------------------------------------------------

SP_SEQ = LONG_SEQ                 # full-width smollm-360m at seq 4096
SP_BATCH = MA_DATA                # global batch 2: one row a dp shard
SP_STEPS = 3
SP_LOSS_RTOL = 1e-3               # each step's loss against the manual run's
SP_BUDGET_S = 120.0
# (label, seq_parallel, overlap, loss scale), all uncoded rhd_rsa (the
# model bracket).  "manual x3" is the witness for what rounding alone
# does to p3 - p0: the manual step under loss scaling by 3 (the loss
# times 3, each parameter's gradient divided by 3), the same function
# and update with every rounding of the backward changed.
SP_RUNS = (("manual", False, False, 1.0), ("manual x3", False, False, 3.0),
           ("sp", True, False, 1.0), ("sp overlap", True, True, 1.0))
SP_WITNESS = "manual x3"
SP_LAUNCHES = ("adamw_update", "fused_rmsnorm",
               "flash_attention_fwd[q_offset]",
               "flash_attention_bwd[q_offset]")
# K7/K8's offset build at a model rank's chunk: the second half of the
# sequence's queries (Sq = S/2 at q_off = S/2) against every key, at
# phase 4's and phase 6's shapes.
OFFSET_ATTN = ((ATTN_SHAPE, ""), (GEMMA_ATTN, " dh256"))
OFFSET_TOL = {"flash_attention_fwd[q_offset]": 0.015625,
              "flash_attention_bwd[q_offset]": 0.03125}


def offset_flash_rows(gen):
    """K7/K8 with a query offset against their plain versions, bf16 and
    f32, causal, at :func:`check_flash`'s per-dtype atol/rtol and within
    :data:`OFFSET_TOL` (the largest absolute difference K7 and K8 show at
    the square shapes), the output rows bit for bit the square launch's
    rows from the offset on, then timed (``TURN_REPS``
    calls in turns) beside SDPA with the same mask as a boolean
    ``attn_mask`` and beside the square launch of the whole sequence.
    Returns the two rows (bf16 at dh 64; every case a variant)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fla
    cuda = torch.device("cuda")
    fwd_rows, bwd_rows = {}, {}
    for shape, tag in OFFSET_ATTN:
        b, s_, h, dh = shape
        off = s_ // 2
        sq = s_ - off
        # query i (position off + i) sees keys 0 .. off + i
        pairs = b * h * sum(range(off + 1, s_ + 1))
        mask = torch.arange(off, s_, device=cuda)[:, None] \
            >= torch.arange(s_, device=cuda)[None, :]
        base = [torch.randn(shape, generator=gen, device=cuda)
                for _ in range(4)]
        for name, dtype, size in (("bf16", torch.bfloat16, 2),
                                  ("f32", torch.float32, 4)):
            q_all, k, v, do_all = (t.to(dtype) for t in base)
            q, do = q_all[:, off:].contiguous(), do_all[:, off:].contiguous()
            kw = dict(causal=True, window=0, q_offset=off)
            out, lse = fla.flash_attention_fwd(q, k, v, **kw)
            grads = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            full, full_lse = fla.flash_attention_fwd(q_all, k, v)
            pout, plse = fla.flash_fwd_plain(q, k, v, chunk=1024, **kw)
            pgrads = fla.flash_bwd_plain(q, k, v, pout, plse, do,
                                         chunk=1024, **kw)
            torch.cuda.synchronize()
            err = {"flash_attention_fwd[q_offset]": max(
                max_abs(out, pout), max_abs(lse, plse)),
                "flash_attention_bwd[q_offset]": max(
                    max_abs(g, p) for g, p in zip(grads, pgrads))}
            tol_f, tol_b = _flash_tol(dtype)
            excess = {"flash_attention_fwd[q_offset]": max(
                _excess(out, pout, *tol_f), _excess(lse, plse, *tol_f)),
                "flash_attention_bwd[q_offset]": max(
                    _excess(g, p, *tol_b) for g, p in zip(grads, pgrads))}
            what = f"{tuple(shape)} {name} Sq {sq} at q_off {off}"
            for key, e in err.items():
                MAX_ERR[key] = max(MAX_ERR[key], e)
                require(excess[key] <= 1.0, f"{key} {what}: max err/tol "
                        f"{excess[key]:.3f} against the plain version at "
                        f"check_flash's atol/rtol")
                require(e <= OFFSET_TOL[key], f"{key} {what}: max |diff| "
                        f"{e} from the plain version > {OFFSET_TOL[key]}")
            # the offset launch's tiles are the square launch's tiles from
            # row off (a multiple of every tile height), so its rows are
            # the square launch's bits
            require(bits_equal(out, full[:, off:])
                    and bits_equal(lse, full_lse[..., off:]),
                    f"K7 offset {what}: output rows differ from the square "
                    f"launch's rows {off}..")
            log(f"  K7/K8 offset {what}: max err/tol fwd "
                f"{excess['flash_attention_fwd[q_offset]']:.3f} bwd "
                f"{excess['flash_attention_bwd[q_offset]']:.3f}, max |diff| "
                f"fwd {err['flash_attention_fwd[q_offset]']:.3g} bwd "
                f"{err['flash_attention_bwd[q_offset]']:.3g}; output rows "
                f"bit for bit the square launch's rows {off}..")
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
            elems_q, elems_k = b * sq * h * dh, b * s_ * h * dh
            cases = (
                ("flash_attention_fwd[q_offset]", fwd_rows,
                 lambda: fla.flash_attention_fwd(q, k, v, **kw),
                 lambda: fla.flash_fwd_plain(q, k, v, chunk=1024, **kw),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                        attn_mask=mask),
                 lambda: fla.flash_attention_fwd(q_all, k, v),
                 (2 * elems_q + 2 * elems_k) * size + 4 * b * h * sq,
                 4 * pairs * dh),
                ("flash_attention_bwd[q_offset]", bwd_rows,
                 lambda: fla.flash_attention_bwd(q, k, v, out, lse, do,
                                                 **kw),
                 lambda: fla.flash_bwd_plain(q, k, v, out, lse, do,
                                             chunk=1024, **kw),
                 lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                             retain_graph=True),
                 lambda: fla.flash_attention_bwd(q_all, k, v, full,
                                                 full_lse, do_all),
                 (4 * elems_q + 4 * elems_k) * size + 8 * b * h * sq,
                 8 * pairs * dh))
            for key, table, fn, plain, library, square, n_bytes, n_flops \
                    in cases:
                runs = {fn: [], library: [], square: []}
                for f in (fn, library, square, square, library, fn):
                    runs[f].append(time_ms(f, reps=TURN_REPS))
                ms = sum(runs[fn]) / 2
                b_ms, by = bound_ms(n_bytes, n_flops, name == "bf16")
                table[name + tag] = {
                    "ms": ms, "plain_ms": time_ms(plain),
                    "library_ms": sum(runs[library]) / 2,
                    "square_ms": sum(runs[square]) / 2,
                    "bound_ms": b_ms, "bound_by": by}
                log(f"  {key:30s} {what}: {ms:.4f} ms (bound {b_ms:.4f} "
                    f"ms by {by}; plain {table[name + tag]['plain_ms']:.4f};"
                    f" SDPA with the boolean mask "
                    f"{table[name + tag]['library_ms']:.4f}; the square "
                    f"launch of all {s_} queries "
                    f"{table[name + tag]['square_ms']:.4f}; turns "
                    f"{[round(x, 4) for x in runs[fn]]})")
            del q_all, k, v, do_all, q, do, out, lse, grads, full, \
                full_lse, pout, plse, pgrads, qt, kt, vt, dot, lib_out
            torch.cuda.empty_cache()
        del base, mask
    return {"flash_attention_fwd[q_offset]": {**fwd_rows["bf16"],
                                              "variants": fwd_rows},
            "flash_attention_bwd[q_offset]": {**bwd_rows["bf16"],
                                              "variants": bwd_rows}}


def _sp_args():
    return train_args(full=True, batch=SP_BATCH, seq=SP_SEQ, device="cuda",
                      steps=SP_STEPS, strategy="rhd_rsa", codec="none",
                      mesh=MODEL_MESH)


def _witness(agg):
    """Buckets whose channel issue ended before the backward returned, of
    the overlapped step's buckets (HL002's reading on host times)."""
    ov = agg.last_overlap
    return (sum(b.end_s <= ov.backward_s for b in ov.buckets),
            len(ov.buckets))


def _loss_scaled(model, scale):
    """``model`` under loss scaling: its loss times ``scale`` and each
    parameter's gradient divided by ``scale`` where it leaves the loss."""
    import dataclasses
    import torch
    from repro_torch.tree import tree_map

    class Unscale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g / scale

    def loss(params, batch, seq_group=None):
        value, metrics = model.loss(tree_map(Unscale.apply, params), batch,
                                    seq_group=seq_group)
        return value * scale, metrics
    return dataclasses.replace(model, loss=loss)


def seq_parallel_rank(rank, world, twin):
    """On the data 2 x model 2 mesh (``cuda_ipc``): each run of
    :data:`SP_RUNS` (full-width smollm-360m, seq 4096, global batch 2,
    K5 AdamW) from one seed, with per-step losses, gradient norms,
    launches, step time, peak allocated memory and the overlap witness,
    and what 3 steps changed (p3 - p0) held against the manual run's;
    then (b) phase 10's configuration overlapped (with its post-backward
    twin when ``twin`` is None)."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_spec
    from repro_torch.core import dist as core_dist
    from repro_torch.core import plan_cache
    from repro_torch.launch.mesh import make_groups
    from repro_torch.launch.train import aggregator_config, build_trainer
    from repro_torch.models import build_model

    args = _sp_args()
    torch.cuda.set_device(0)
    groups = make_groups(1, MA_DATA, MA_MODEL)
    del groups["pod"]
    require(groups["model"].transport == "cuda_ipc",
            "the mesh's groups are not on cuda_ipc")

    def train(args, model, overlap, keep_delta=False):
        n0 = len(core_dist._open_channels)
        trainer = build_trainer(
            args, verbose=False, model=model, groups=groups,
            aggregator=dataclasses.replace(aggregator_config(args),
                                           overlap=overlap))
        module, opt_state = trainer.init_state(args.seed)
        p0 = [t.detach().clone() for t in tree.leaves(module.tree())] \
            if keep_delta else []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        steps = []
        _reset_counts()                        # main path starts here
        for s in range(args.steps):
            before = _counts()
            module, opt_state, hist = trainer.run(1, module, opt_state,
                                                  start_step=s)
            after = _counts()
            steps.append({**hist[0], "launches": {
                k: after[k] - before[k] for k in after},
                "witness": _witness(trainer.extras["aggregator"])
                if overlap else None})
        totals = _counts()                     # main path ends here
        peak = torch.cuda.max_memory_allocated()
        rec = {"steps": steps, "totals": totals,
               "scalar": _scalar_counts(),
               "peak_gib": peak / 2 ** 30,
               "step_peak_gib": (peak - start) / 2 ** 30,
               "checksum": _checksum(module.tree()),
               "render": trainer.extras["aggregator"].last_schedule.render()}
        delta = [(p.detach() - q).float() for p, q in
                 zip(tree.leaves(module.tree()), p0)]
        del trainer, module, opt_state, p0
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()    # closes the channels
        for ch in list(core_dist._open_channels[n0:]):
            ch.close()                         # the step's own channels
        torch.cuda.empty_cache()
        return rec, delta

    base = get_spec(args.arch)
    runs, manual_delta = {}, None
    for label, sp, overlap, scale in SP_RUNS:
        model = build_model(dataclasses.replace(base, seq_parallel=sp))
        if scale != 1.0:
            model = _loss_scaled(model, scale)
        rec, delta = train(args, model, overlap,
                           keep_delta=label != "sp overlap")
        rec["loss_scale"] = scale
        if label == "manual":
            manual_delta = delta
        elif delta:
            worst = {"excess": float("-inf"), "diff": 0.0, "outside": 0}
            with torch.no_grad():
                for d, m in zip(delta, manual_delta):
                    diff = (d - m).abs()
                    excess = diff - (MA_ATOL + MA_RTOL * m.abs())
                    worst["excess"] = max(worst["excess"],
                                          float(excess.max()))
                    worst["diff"] = max(worst["diff"], float(diff.max()))
                    worst["outside"] += int((excess > 0).sum())
            rec["distance"] = worst
        del delta
        runs[label] = rec
    del manual_delta
    # (b) phase 10's configuration, overlapped on the model axis.
    args10 = _model_args("none")
    b = {"overlap": train(args10, None, True)[0]}
    if twin is None:
        b["post"] = train(args10, None, False)[0]
    return {"rank": rank, "runs": runs, "b": b}


def run_seq_parallel_phase(phase10=None, phase11=None, phase16=None):
    """Phase 17 on the 4 ranks of the card laid out as data 2 x model 2
    (one ``cuda_ipc`` spawn): full-width smollm-360m at seq 4096 with
    ``seq_parallel`` (each model rank's chunk of 2048 positions, K7/K8's
    offset build) against the manual step, each step's loss and the
    first step's gradient norm within :data:`SP_LOSS_RTOL`, no more
    elements of p3 - p0 outside the manual run's than the loss-scaled
    witness (:data:`SP_WITNESS`) leaves, every rank's peak allocated
    memory below the manual run's, the overlapped SP run bit for bit the
    SP run; (b)
    phase 10's run overlapped, bit for bit phase 10's post-backward run
    (its twin in this spawn when phase 10 did not run), HL002's witness
    printed; (c) F9's measure: phase 11(b)'s hop host time split into
    issue and the card's clock, and phase 16's host time per hop.
    Returns each rank's record."""
    from repro_torch.core import reducers
    from repro_torch.core.dist import run_ranks
    t0 = time.perf_counter()
    twin = None if phase10 is None else {
        r["rank"]: next(run["checksum"] for run in r["runs"]
                        if run["label"] == "cuda_ipc") for r in phase10}
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(seq_parallel_rank, MA_DATA * MA_MODEL, (twin,),
                            backend="cuda_ipc", rendezvous_dir=rdv,
                            timeout_s=900)
    seconds = time.perf_counter() - t0
    log(f"  (a) smollm-360m, seq {SP_SEQ}, mesh {MODEL_MESH} (data "
        f"{MA_DATA} x model {MA_MODEL}) on cuda_ipc, global batch "
        f"{SP_BATCH}, bf16, rhd_rsa (bracketed), K5 AdamW, {SP_STEPS} "
        f"steps a run, one spawn; plans: "
        f"{ {k: v['render'] for k, v in results[0]['runs'].items()} }")
    for r in results:
        man = r["runs"]["manual"]
        for label, run in r["runs"].items():
            scale = run["loss_scale"]
            losses = [st["loss"] / scale for st in run["steps"]]
            norms = [st["grad_norm"] for st in run["steps"]]
            times = [round(st["step_s"], 4) for st in run["steps"]]
            dist_ = run.get("distance")
            log(f"    rank {r['rank']} {label:11s} losses "
                f"{[round(x, 6) for x in losses]}, gradient norms "
                f"{[round(x, 6) for x in norms]}"
                + (f" (losses over the loss scale {scale})" if scale != 1
                   else "")
                + f", step s {times}, peak "
                f"allocated {run['peak_gib']:.3f} GiB (the steps' own "
                f"{run['step_peak_gib']:.3f}), launches "
                f"{ {k: run['totals'][k] for k in SP_LAUNCHES} }"
                + (f", overlap witness {[st['witness'] for st in run['steps']]}"
                   if run["steps"][0]["witness"] else "")
                + (f"; p3 - p0 against the manual run's: largest diff "
                   f"{dist_['diff']:.3g}, worst excess over {MA_ATOL} + "
                   f"{MA_RTOL}|x| {dist_['excess']:.3g}, "
                   f"{dist_['outside']} elements outside" if dist_ else ""))
            if label in ("manual", SP_WITNESS):
                continue
            for s_, (a, b) in enumerate(zip(losses, [st["loss"] for st in
                                                     man["steps"]]), 1):
                require(abs(a - b) <= SP_LOSS_RTOL * abs(b),
                        f"rank {r['rank']} {label} step {s_}: loss {a} not "
                        f"within {SP_LOSS_RTOL} of the manual run's {b}")
            # the first step's aggregated gradient (the same parameters in
            # both runs) by its global norm: a gradient sum over the
            # sequence chunks that drops or double-counts a chunk moves it
            # by far more than the tolerance.  From the second step on the
            # parameters differ by rounding, and so do the norms.
            a, b = norms[0], man["steps"][0]["grad_norm"]
            require(abs(a - b) <= SP_LOSS_RTOL * abs(b),
                    f"rank {r['rank']} {label} step 1: gradient norm {a} "
                    f"not within {SP_LOSS_RTOL} of the manual run's {b}")
            # held by the count: the largest difference is an AdamW step
            # size or two either way (one update whose sign flips), so it
            # is printed beside the witness's, not compared
            if dist_:
                wit = r["runs"][SP_WITNESS]["distance"]
                require(dist_["outside"] <= wit["outside"],
                        f"rank {r['rank']} {label}: p3 - p0 against the "
                        f"manual run's, {dist_['outside']} elements outside, "
                        f"more than rounding alone gives ({SP_WITNESS}: "
                        f"{wit['outside']})")
            require(run["peak_gib"] < man["peak_gib"],
                    f"rank {r['rank']} {label}: peak {run['peak_gib']:.3f} "
                    f"GiB not below the manual run's {man['peak_gib']:.3f}")
            for k in SP_LAUNCHES:
                require(run["totals"][k] > 0, f"rank {r['rank']} {label}: "
                        f"{k} never launched on the main path")
        sp, ov = r["runs"]["sp"], r["runs"]["sp overlap"]
        require(ov["checksum"] == sp["checksum"]
                and [st["loss"] for st in ov["steps"]]
                == [st["loss"] for st in sp["steps"]],
                f"rank {r['rank']}: the overlapped SP run's parameters "
                f"differ from the SP run's")
    log(f"    every SP step's loss and the first step's gradient norm "
        f"within {SP_LOSS_RTOL} of the manual run's, SP's p3 - p0 with no "
        f"more elements outside the manual run's than {SP_WITNESS}'s "
        f"(rounding alone) and every rank's peak below the manual run's; "
        f"the overlapped SP run bit for bit the SP run on every rank")
    for r in results:
        want = (r["b"]["post"]["checksum"] if "post" in r["b"]
                else next(run["checksum"] for p10 in phase10
                          if p10["rank"] == r["rank"] for run in p10["runs"]
                          if run["label"] == "cuda_ipc"))
        require(r["b"]["overlap"]["checksum"] == want,
                f"rank {r['rank']}: phase 10's run overlapped differs from "
                f"its post-backward run")
    log(f"  (b) phase 10's run (seq 512, global batch 8, uncoded rhd_rsa on "
        f"cuda_ipc) with overlap=True: bit for bit "
        f"{'its twin in this spawn' if phase10 is None else 'phase 10'} "
        f"on every rank; HL002's witness per rank and step (not required: "
        f"layer-stacked leaves) "
        f"{[[st['witness'] for st in r['b']['overlap']['steps']] for r in results]}")
    if phase11:
        _log_hop_split(phase11, "  (c) phase 11(b)")
    if phase16:
        for transport, row in phase16["measured"]["rows"]:
            if transport != "cuda_ipc" or row["design"] != "Horovod_MPI_Opt":
                continue
            hops = reducers.allreduce_steps("rhd_rsa", row["p"])
            lats = [b["predicted_s"] for b in row["schedule"]["buckets"]]
            log(f"  (c) phase 16 cuda_ipc rhd_rsa {row['model']} p="
                f"{row['p']}: {hops} hops a bucket, host ms per hop "
                f"{[round(x * 1e3 / hops, 3) for x in lats]}")
    log(f"  phase 17 {seconds:.1f} s (budget {SP_BUDGET_S:.0f} s) on "
        f"{gpu_line()}")
    return results


def _ipc_wait_row(phase11):
    """The JSON record's ``transport`` row of the cuda_ipc channel's
    wait on the card (phase 11): the waits it enqueued on the main path
    ((a), (b) and (e)), the largest difference from gloo in (f), and a
    4 KiB ring hop's ms on the card's clock beside gloo's (the
    host-staged hop).  It is no kernel: the driver's stream memory
    operations in place of a hop's host waits, not of a Pallas kernel,
    and a hop's time is a latency (the peers' contexts time-slicing the
    card), so it has no byte or operation bound."""
    waits = sum(r[p]["device_waits"] for r in phase11
                for p in ("lm", "cnn", "lm_overlap"))
    require(waits > 0, "the channel's wait on the card never launched")
    checks = [r["ipc_check"] for r in phase11]
    return {"name": "ipc_wait", "kind": "transport",
            "mechanism": "cuStreamWaitValue64 / cuStreamWriteValue64",
            "source": "src/repro_torch/kernels/csrc/mailbox.cu",
            "replaces": None,
            "in_place_of": "a cuda_ipc hop's host waits (the reference's "
                           "ppermute, src/repro/core/compat.py:143)",
            "waits": waits, "waits_by_phase": {"phase11": waits},
            "max_abs_err": max(c["max_abs"] for c in checks),
            "hop_ms": max(c["ms"] for c in checks),
            "hop_bytes": PINGPONG_BYTES,
            "gloo_hop_ms": max(c["plain_ms"] for c in checks)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve-only", action="store_true",
                    help="build the kernels and run phase 12 alone")
    ap.add_argument("--family-only", action="store_true",
                    help="build the kernels and run phase 13 alone")
    ap.add_argument("--recurrent-only", action="store_true",
                    help="build the kernels and run phase 14 alone (with "
                         "phase 4's run for remat's comparison)")
    ap.add_argument("--analysis-only", action="store_true",
                    help="build the kernels and run phases 11 and 15 "
                         "alone (not held to phases 3-8)")
    ap.add_argument("--characterization-only", action="store_true",
                    help="build the kernels and run phase 16 alone")
    ap.add_argument("--seq-parallel-only", action="store_true",
                    help="build the kernels, check and time K7/K8 with a "
                         "query offset and run phase 17 alone (its (b) "
                         "against a twin in its spawn, no (c))")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import backend

    # Plain versions on the card are references: full f32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.serve_only:
        backend.build_all()
        log("phase 12 alone")
        run_serve_phase()
        print(gpu_line(), flush=True)
        return 0
    if opts.family_only:
        backend.build_all()
        log("phase 13 alone")
        run_family_phase()
        print(gpu_line(), flush=True)
        return 0
    if opts.recurrent_only:
        backend.build_all()
        log("phase 14 alone")
        run_recurrent_phase()
        print(gpu_line(), flush=True)
        return 0
    if opts.analysis_only:
        backend.build_all()
        log("phases 11 and 15 alone")
        phase11 = run_telemetry_phase(None, None)
        log("phase 15: analysis/ and the planning tools")
        run_analysis_phase(phase11=phase11)
        print(gpu_line(), flush=True)
        return 0
    if opts.characterization_only:
        backend.build_all()
        log("phase 16 alone")
        run_characterization_phase()
        print(gpu_line(), flush=True)
        return 0
    if opts.seq_parallel_only:
        backend.build_all()
        log("K7/K8 with a query offset, then phase 17 alone")
        offset_flash_rows(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.empty_cache()
        run_seq_parallel_phase()
        print(gpu_line(), flush=True)
        return 0
    t_start = time.perf_counter()
    marks = []

    def phase(title):
        """Log a phase's title with the seconds since the run began."""
        now = time.perf_counter()
        marks.append((title.split(":")[0], now))
        log(f"{title} [at {now - t_start:.1f} s]")

    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    phase("phase 1: build (the flash kernels' nvcc runs on while phase 2 "
          "checks K1-K5 and phases 3 and 5 train)")
    t0 = time.perf_counter()
    # The flash source takes the longest to compile; nothing before
    # check_flash loads it (phase 3's seq 512 and small model's 32 stay
    # under attn_full_seq_max).
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    flash = pool.submit(backend.build_all, (FLASH_SOURCE,))
    reports = backend.build_all(tuple(s for s in backend.SOURCES
                                      if s != FLASH_SOURCE))
    for name, text in reports.items():
        report_build(name, text)
    log(f"  built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    phase("phase 2: K1-K5 vs plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_hop_kernels(gen)
    check_fused_reduce(gen)
    check_adamw(gen)
    torch.cuda.empty_cache()     # the ranks of phase 3 share the card

    phase("phase 3: train full-width smollm-360m, seq 512")
    args = train_args(full=True, batch=2 * TRAIN_WORLD, seq=512,
                      device="cuda")
    small = train_args(full=False, batch=2 * TRAIN_WORLD, seq=32, steps=2,
                       dtype="float32")
    main_path = ("hop_absmax", "hop_encode", "hop_decode_add",
                 "adamw_update", "fused_rmsnorm")
    phase3 = run_phase(TRAIN_WORLD, args, small, main_path)

    # Phase 5 runs no flash kernel: it trains while the flash source
    # still compiles.
    phase("phase 5: the paper's CNNs, full-width ResNet-50 and MobileNet-v1 "
          f"at {CNN_IMAGE}x{CNN_IMAGE}")
    phase5 = run_cnn_phase()

    phase("phase 2: K6 fused_rmsnorm and K7/K8 flash attention")
    reports = flash.result()
    pool.shutdown()
    for name, text in reports.items():
        report_build(name, text)
    log(f"  built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s from the start of phase 1")
    check_rmsnorm(gen)
    check_flash(gen)
    check_delta(gen)
    rows = measure(gen)
    phase("phase 2: K7/K8 with a query offset (phase 17's sequence chunks)")
    rows.update(offset_flash_rows(gen))
    torch.cuda.empty_cache()     # the ranks of phases 4-6 share the card

    phase(f"phase 4: long context, full-width smollm-360m at seq {LONG_SEQ}")
    args = train_args(full=True, batch=LONG_WORLD, seq=LONG_SEQ,
                      steps=LONG_STEPS, device="cuda")
    small = train_args(full=False, batch=2 * LONG_WORLD, seq=128, steps=2,
                       dtype="float32")
    phase4 = run_phase(LONG_WORLD, args, small,
                       tuple(k for k in KERNELS if k != "fused_reduce"))
    for r in phase4:
        for s_, rec in enumerate(r["steps"]):
            for k in ("flash_attention_fwd", "flash_attention_bwd"):
                require(rec["launches"][k] == LAYERS,
                        f"rank {r['rank']} step {s_ + 1}: {k} launched "
                        f"{rec['launches'][k]} times, not once per layer")
    fb = min(r["breakdown"]["fwd_bwd_s"] for r in phase4)
    attn_s = LAYERS * (rows["flash_attention_fwd"]["ms"]
                       + rows["flash_attention_bwd"]["ms"]) / 1e3
    log(f"  attention kernels (K7+K8 at phase 2's per-layer times x "
        f"{LAYERS} layers) {attn_s:.3f} s of the {fb:.3f} s "
        f"forward+backward of one rank alone: {attn_s / fb:.1%}")

    phase(f"phase 6: long context, full-width gemma-7b at seq {LONG_SEQ}")
    phase6 = run_gemma_phase(rows)

    phase("phase 7: phases 3, 5 and 6 on the cuda_ipc transport")
    phase7 = run_transport_phase(rows, phase3, phase5, phase6)

    phase("phase 8: strategy='auto' and overlap=True (in-backward "
          "reductions) on cuda_ipc")
    phase8 = run_overlap_phase(phase7)

    phase(f"phase 9: two dp axes, mesh {TWO_AXIS_MESH}: {COMPOSED} + "
          f"{LEVEL_CODECS} on gloo and cuda_ipc, overlapped, and auto")
    phase9 = run_two_axis_phase(phase7)

    phase(f"phase 10: the model axis, mesh {MODEL_MESH} (data x model): "
          f"rhd_rsa on gloo and cuda_ipc, rhd_rsa + int8 on cuda_ipc")
    phase10 = run_model_axis_phase(phase3)

    phase("phase 11: telemetry on the training path (REPRO_TRACE in the "
          "ranks): smollm-360m as phase 7, the closure, ResNet-50 as phase "
          "8, the trace file")
    phase11 = run_telemetry_phase(phase7, phase8)

    # Phase 15's dry run needs no card: it runs beside phases 12-14.
    dry_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    dry = dry_pool.submit(_dryrun_records)

    phase(f"phase 12: serving: gemma-7b at full width and depth (prompt "
          f"{SERVE_PROMPT}, K7 in prefill), card against host, smollm-360m "
          f"on --mesh {RANK_MESH} ranks")
    phase12 = run_serve_phase()

    phase(f"phase 13: the rest of the transformer family: {DSV2} and {PHI3} "
          f"served at full width and depth, {GRANITE_MOE} and {PHI3} trained "
          f"on {FAMILY_WORLD} cuda_ipc ranks (depth cut), the reduced specs "
          f"card against host")
    phase13 = run_family_phase()

    phase(f"phase 14: the recurrent and encoder-decoder families: {ZAMBA2}, "
          f"{XLSTM} and {WHISPER} served at full width and depth and trained "
          f"on {LONG_WORLD} cuda_ipc ranks, the reduced specs card against "
          f"host, remat against phase 4")
    phase14 = run_recurrent_phase(phase4)

    phase("phase 15: analysis/ and the planning tools: the schedule and "
          "source gate, phase 11's hop lint, the dry run on 16x16 and "
          "2x16x16, the estimates against phases 3, 4 and 6")
    run_analysis_phase(phase3, phase4, phase6, phase11, dry)
    dry_pool.shutdown()

    phase("phase 16: the characterization: regen --check and the claims, "
          "the measured backend on the card, dryrun --trace, the closure "
          "artifact")
    phase16 = run_characterization_phase()

    phase(f"phase 17: seq_parallel and overlap on the model axis: "
          f"full-width smollm-360m at seq {SP_SEQ} on mesh {MODEL_MESH} "
          f"(K7/K8's offset build), phase 10 overlapped, F9's measure")
    phase17 = run_seq_parallel_phase(phase10, phase11, phase16)

    def phases(field, k):
        return {"phase3": sum(r[field][k] for r in phase3),
                "phase4": sum(r[field][k] for r in phase4),
                "phase5": sum(run[field][k] for r in phase5
                              for run in r["runs"]),
                "phase6": sum(r[field][k] for r in phase6),
                "phase7": sum(r[field][k] for r in phase7["lm"]
                              + phase7["gemma"])
                + sum(run[field][k] for r in phase7["cnn"]
                      for run in r["runs"]),
                "phase8": sum(run[field][k] for r in phase8["lm"]
                              + phase8["cnn"] for run in r["runs"]),
                "phase9": sum(run[field][k] for r in phase9
                              for run in r["runs"]),
                "phase10": sum(run[field][k] for r in phase10
                               for run in r["runs"]),
                "phase11": sum(r[part][field][k] for r in phase11
                               for part in ("lm", "cnn", "lm_overlap")),
                "phase12": phase12["gemma"][field][k]
                + sum(r[field][k] for r in phase12["ranks"]),
                "phase13": phase13["a"][field][k] + phase13["b"][field][k]
                + sum(r[field][k] for r in phase13["c"] + phase13["d"]),
                "phase14": sum(phase14[p][field][k]
                               for p in ("(a)", "(b)", "(c)"))
                + sum(r[field][k] for r in phase14["d"] + phase14["f"]),
                "phase17": sum(run[field][k] for r in phase17
                               for run in (*r["runs"].values(),
                                           *r["b"].values()))}

    def scalar(k):
        if k not in SCALAR:
            return {}
        by_phase = phases("scalar", k)
        return {"scalar_launches": sum(by_phase.values()),
                "scalar_launches_by_phase": by_phase}

    record = {"kernels": [
        {"name": k, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/"
                   f"{KERNELS[OFFSET_KERNELS.get(k, k)][0]}",
         "replaces": KERNELS[OFFSET_KERNELS.get(k, k)][1],
         "launches": sum(phases("totals", k).values()),
         "launches_by_phase": phases("totals", k), **scalar(k),
         "max_abs_err": MAX_ERR[k], **rows[k]}
        for k in (*KERNELS, *OFFSET_KERNELS)]}
    record["transport"] = [_ipc_wait_row(phase11)]
    end = time.perf_counter()
    spans = collections.defaultdict(float)
    for (name, t0_), (_, t1_) in zip(marks, marks[1:] + [("", end)]):
        spans[name] += t1_ - t0_
    log(f"seconds by phase: { {k: round(v, 1) for k, v in spans.items()} }")
    log(f"total {end - t_start:.1f} s")
    print(json.dumps(record), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
