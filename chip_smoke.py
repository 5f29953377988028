#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build the CUDA kernel libraries of ``_build.SOURCES`` (eleven sources
   under ``src/repro_torch/csrc``, one nvcc each, all at once;
   ``int8_matmul.cu`` holds the forward's two routes -- the decode step's
   split-K weight stream reduced in a thread-block cluster (one kernel,
   also the fused entry that quantizes fp activations per token), its
   weight transpose and int8 tensor-core GEMM (``gemm_s8.cuh``, shared with
   the backward) -- and the first CUDA-core dp4a kernel; ``decode_attn.cu``
   the dense and the paged decode kernels; ``flash_attn.cu`` the float32 flash
   forward and both backward kernels; ``flash_fwd_sm90.cu`` the bf16 flash
   forward on the tensor cores, ``flash_bwd_sm90.cu`` and
   ``flash_bwd_sm90_wide.cu`` its backward at head dims 16-128 and 144-256 (the
   parts they share in ``flash_bwd_sm90.cuh``); ``flash_q8_sm90.cu`` the bf16
   int8-KV prefill on the tensor cores, ``flash_attn_q8.cu`` its float32
   instance; ``int8_matmul_bwd.cu`` the int8 backward's quantize passes, 2-D
   and expert-batched) and print
   the build time;
2. print the card's name and power limit (nvidia-smi);
3. hold each serving kernel against its plain PyTorch version on the card
   at the serving path's shapes, and time kernel, plain version and a
   library yardstick (``torch._int_mm``; SDPA on dequantized K/V) beside
   the bound computed from the inputs' bytes and operations:
   ``int8_matmul`` bit for bit on both its routes (the cluster route up
   to 16 rows, a repeat bit-identical) and the first dp4a kernel at M =
   16, 17, 32, 64, 2048 and 8192, bf16 and float32 output, each timed call
   by call and queued (``queued_ms``), at M = 16 also over the decode
   step's 72 weights with the L2 cold; the fused decode entry
   ``int8_quant_matmul`` bit for bit at M = 1, 7 and 16, both carriers,
   and on rows holding a NaN or an infinity, timed against quantize_int +
   ``int8_matmul``; the forward's GEMM kernels holding
   ``IGMMA``, the cluster kernels ``IMMA`` (``check_int8_matmul``);
   ``flash_attention_fwd_q8`` at the serving gate
   and the engine's shapes, bf16 within one bf16 step and its output
   before the cast within ``Q8_TOL``, float32 within ``Q8_TOL``, timed
   beside the CUDA-core kernel at bf16, the ``flash_q8_sm90`` kernels holding
   ``HGMMA`` (``check_flash_q8``); ``decode_attention`` at 16 slots of 1024
   rows with positions on its chunk edges, within 1e-3 at float32 (one bf16
   step at bf16), the written rows bit for bit, a second launch
   bit-identical, timed queued and call by call beside SDPA
   (``check_decode_attention``); 3b. the paged decode kernel the same way
   at pages of 16, 64 and 256 rows, and bit for bit against the dense
   decode kernel on the same logical cache
   (``check_decode_attention_paged``);
4. serve GPT-2 small (random weights from ``--seed``, bf16 carrier, W8A8
   prepared weights, int8 KV cache) through the continuous-batching engine:
   32 requests, prompts of 32-512 tokens, 64 new tokens each, 16 slots of
   1024 rows; every kernel must have launched, as often as the engine's
   prefill and decode counts say; 4b. the same requests through the paged
   engine (pages of 64 rows) under the async scheduler, arriving with
   exponential gaps: phase 4's tokens, the paged kernel's launch counts,
   peak live KV below the dense cache, every page back (``serve_paged``);
   4c. preemption under a 24-page pool and prefix sharing
   (``serve_paged_pressure``);
5. teacher-forced logits of the card against the CPU (plain versions) at
   the float32 carrier on the same weights, and of the card with the
   plain ``int8_matmul`` in the kernel's place (see ``card_vs_cpu`` for
   the policies, the weights and the limits);
6. hold the training kernels against their plain versions at the training
   path's shapes -- ``int8_matmul_nt`` and ``int8_matmul_tn`` bit for bit
   at M = 8192 tokens (the three (K, N) at bf16, (768, 768) at fp32), a
   second launch bit-identical to the first -- and time each beside its
   bound, its plain version and a yardstick (``torch._int_mm`` on int8
   operands of the same contraction), with the card's queue full, and each
   of their stages (quantize pass, int8 GEMM, split reduction) timed alone;
   every GEMM kernel of ``int8_matmul_bwd.cu`` holds integer wgmma
   (``IGMMA``) in its SASS (``cuobjdump``), or the phase fails
   (``check_int8_bwd``); 6b. the fused AdamW kernel's two entries:
   ``fused_adamw_blocks`` on a bucket of GPT-2 small's size and
   ``fused_adamw_leaves`` on GPT-2 small's own leaves (two steps, the
   second reading the first's views), each bit for bit in params, payloads,
   scales and zero points, the update-norm sum within 1e-5 relative, a
   repeat bit-identical, timed queued beside the byte bound and the plain
   version (no PyTorch yardstick); the kernel holds bulk copies
   (``UBLKCP``) in its SASS, or the phase fails; then ``adamw_update``'s
   device time on GPT-2 small and its kernels by kind
   (``check_fused_adamw``);
7. train GPT-2 small at full width and depth (random weights from
   ``--seed``, bf16 carrier, 8 x 1024 tokens a step from the port's
   synthetic corpus, the paper's W8/A8/G8 recipe on the int8 kernels with
   blockwise 8-bit Adam moments) for 10 steps: ce, grad norm and ms per
   step, tokens/s, peak memory and, over one profiled step, the device's
   idle share; every ce and grad norm must be finite and each training
   kernel (nt, tn, the forward, ``fused_adamw_leaves``) must launch
   exactly 72 / 72 / 72 / 1 times a step (and the serving kernels and the
   bucket entry ``fused_adamw_blocks`` never);
8. one train step on gpt2-mini, card against CPU (see
   ``train_card_vs_cpu`` for the checks and their limits);
9. the fake-quant gradient kernels ``qdq_row`` and ``qdq_scaled`` bit for
   bit against their plain versions at the gradients' shapes, timed with
   the L2 cold, queued and call by call, beside their bound, plain version
   and a fake-quantize yardstick; ``qdq_row``'s streaming kernel holds bulk
   copies (``UBLKCP``) in its SASS, or the phase fails (``check_qdq``);
10. GPT-2 small at full width through the port's ``Trainer`` under the
    fake-quant recipes ``paper_wag8`` (10 steps: ms/step, tokens/s, peak
    memory, idle share), ``w8c,a8t,g8n`` and ``w8c,a8t,g8c``: 72 qdq
    launches a step and no other kernel (``train_fake``);
11. the guarded path at full width: the sentinel, async checkpoints under
    ``build/`` (removed after), ``nan_grad@5`` over 12 steps; the ladder
    equals ``LADDER_EXPECT`` and each primary and fallback step launches
    exactly its kernels (``train_guarded``); 11b. SIGTERM after a step,
    then resume: bit-identical to the uninterrupted run (``train_resume``);
12. one ``paper_wag8`` step on gpt2-mini, card against CPU, and with the
    plain qdq in the kernels' place; a bf16-carrier step, the control,
    must exceed every limit (``train_fake_card_vs_cpu``);
13. the fp flash kernels #7-#10 against their plain versions at the
    training shape (BH = 96, S = 1024, hd = 64) and ``FLASH_SWEEP`` (head
    dims 16-256, Sq != Skv, an odd length, non-causal, the prefill
    shape), float32 and bfloat16, on the same inputs, within ``FLASH_TOL``
    and, at bfloat16, ``FLASH_BF16`` with five controls outside it; #7
    equal to #8, repeats bit-identical, a NaN planted at hd 64, 160 and
    256 propagated (``FLASH_NAN_HEAD_DIMS``); each
    timed beside its bound (the least the tensor cores need), plain
    version and SDPA (the backward also with the card's queue full), and
    #8, #9 and #10 also at hd 128 (BH 16, S 512); the bf16 forward's and
    both backward libraries' kernels hold ``HGMMA`` instructions in their SASS
    (``cuobjdump``), or the phase fails (``check_flash``);
14. phase 7 with ``attention_impl="flash_pallas"``: 10 finite steps, each
    launching exactly 72 / 72 / 72 / 1 int8 and AdamW kernels and #8, #9,
    #10 12 times (``train(impl="flash_pallas")``); 14b. the dense engine
    with an fp KV cache and the flash setting: 8 of phase 4's prompts
    answered to length, #8 12 times per prefill launch, #9/#10 never
    (``serve_flash``);
15. the flash path at float32 under ``*=fp`` against the CPU, against
    ``_attend`` and against its plain versions on the card, within
    ``FLASH_LIMITS`` (``flash_card_vs_cpu``);
16. the llama family at Yi-6B's full width (``configs/yi_6b.py``: 32
    layers, d_model 4096, 32 query heads over 4 KV heads of 128, the gated
    MLP's 11,008, RoPE, RMSNorm, an untied head of 64,000): 16a. the four
    serving kernels at Yi's shapes with phase 3's gates -- ``int8_matmul``
    bit for bit at ``YI_INT8_KN`` x M = 16 and 2048, its fused decode entry
    at M = 16 on finite rows and on rows holding a NaN or an infinity, the
    weight transpose of its tensor-core route and an L2-cold round over the
    decode step's linears timed alone; ``flash_attention_fwd_q8`` at
    ``YI_Q8_SHAPE``; ``decode_attention`` and ``decode_attention_paged`` at
    ``YI_DECODE_SHAPE`` (pages of 16, 64, 256 bit for bit against the dense
    kernel), each timed beside its bound and SDPA on dequantized K/V with
    the KV heads expanded (``cell_kernels``); 16b. serve Yi-6B at
    ``YI_SERVE_LAYERS`` of its 32 layers (random float32 weights from
    ``--seed``, freed once prepared; bf16 carrier, ``POLICY``) through the
    dense engine, 16 slots of 4096 rows, 32 requests of 128-2048 prompt
    tokens, 32 new tokens each: every request to length, exactly 7
    ``int8_matmul`` and one ``decode_attention`` a layer a decode step and
    7 and one ``flash_attention_fwd_q8`` a layer a prefill launch;
    decode ms/step, tokens/s, prefill ms, peak memory, one profiled decode
    step and the untied head's share (``serve_cell``); 16c. the same requests
    through the paged engine (pages of 64 rows): 16b's tokens, one
    ``decode_attention_paged`` a layer a step, every page back
    (``serve_cell_paged``); 16d. phase 5's checks at Yi's width and 2 layers,
    its limits but B's, which is ``YI_B_LIMIT`` there (``cell_card_vs_cpu``);
17. the serving degradation ladder on GPT-2 small (phase 4's weights):
    17a. an engine whose rung 0 is dequantize-on-read (``DEQUANT_POLICY``,
    a per-tensor KV spec no kernel takes), dense and paged, 32 requests of
    one prefill bucket (``ladder_prompts``): ``kv=int8-dequant`` /
    ``kv=int8-paged-gather(p64)``, exactly 72 ``int8_matmul`` a decode
    step and a prefill launch and no other kernel, paged tokens bit-equal
    to dense for every request (``serve_dequant``); 17b. the
    dequant path card against CPU (phase 5's A limit), and an a8t model's
    dequant path against its fused path on the card within
    ``DEQUANT_FUSED_LIMIT``, a bf16-carrier control outside it
    (``dequant_card_vs_cpu``); 17c. ``SERVE_LADDER_PLAN`` on ``POLICY``
    dense and paged: the walk equals ``SERVE_LADDER_EXPECT``, two kernel
    errors, two ``numerics``, #12/#13 12 times a fused-rung step, #11 12
    times a prefill launch, paged tokens and finish reasons equal to
    dense for every request, each rung's decode ms/step (``serve_ladder``);
    17d.
    ``SERVE_OOM_PLAN`` on the paged engine: a preemption, never a
    ``CapacityError``, every request to length and every page back
    (``serve_oom``).  Every healthy serving phase (4, 4b,
    4c, 14b, 16b, 16c, 17a, 17d, 19b, 19c, 20a, 21b, 21c, 23b) fails unless it ends with
    no kernel error, no demotion and rung 0 (``healthy``);
18. llama pre-training at Yi-6B's published widths (random weights from
    ``--seed``, bf16 carrier, ``TRAIN_POLICY`` with int moments, the
    synthetic corpus), the loss recomputing as the reference's
    (``cfg.remat``: per-layer checkpoints that keep the attention context,
    checkpointed CE chunks, ``_attend`` in checkpointed q-chunks): 18a.
    ``YI_TRAIN_LAYERS`` of its 32 layers, 2 x 4096 tokens a step,
    ``flash_pallas``, ``YI_TRAIN_STEPS`` finite steps, each launching exactly
    ``train_launches`` (14 #3 a layer: each linear again in the
    recomputation; 2 #8 a layer), ms/step, tokens/s, peak memory, one
    profiled step (``train_yi``); 18b. at 4 layers, recomputation on
    against off: ce and every gradient bit-identical, the peak lower
    (``yi_remat``); 18c. ``_attend`` in q-chunks of 1024 rows against one
    block (the score budget lifted) at 4 layers x 1 x 4096 tokens within
    ``YI_CHUNK_LIMITS``, then 18a's shape under ``_attend`` (chunks of 512)
    for 2 finite steps (``yi_attend_chunks``); 18d. phase 8's checks at
    Yi's width and 2 layers within ``YI_TRAIN_LIMITS`` (C's asymmetric
    moments dequantized where their zero points differ), and phase 12's
    bf16-carrier control (``yi_train_card_vs_cpu``);
19. Gemma-2B at full width and depth (``configs/gemma_2b.py``: 18 layers,
    d_model 2048, 8 query heads over one KV head of 256, GeGLU 16,384, a
    tied head of 256,000 rows, the embedding scaled by sqrt(d_model),
    RMSNorm with (1 + w)): 19a. phase 16a at ``GEMMA_INT8_KN``,
    ``GEMMA_Q8_SHAPE`` and ``GEMMA_DECODE_SHAPE`` (#11, #12 and #13 at head
    dim 256); 19b. the dense engine (random float32 weights from
    ``--seed``, freed once prepared; bf16 carrier, ``POLICY``), 16 slots of
    8192 rows, 32 requests of 256-6144 prompt tokens, 32 new each: exactly
    126 #3 and 18 #12 a decode step, 126 #3 and 18 #11 a prefill launch,
    rung 0 throughout; 19c. the same requests paged (pages of 64 rows):
    19b's tokens, 18 #13 a step, every page back; 19d. phase 16d at
    Gemma's width and 2 layers with ``GEMMA_B_LIMIT`` and a bf16-carrier
    control that must exceed each limit (``cell_card_vs_cpu``);
20. Qwen3-32B at full width (``configs/qwen3_32b.py``: d_model 5120, 64
    query heads over 8 KV heads of 128, SwiGLU 25,600, qk-norm, RoPE
    theta 1e6, an untied head of 151,936), cut to ``QWEN3_LAYERS`` of its
    64 layers: 20a. #3 bit for bit at ``QWEN3_INT8_KN``, then the dense
    engine, 16 slots of 4096 rows, 16 requests of 128-2048 prompt tokens,
    32 new each: exactly 112 #3 and 16 #12 a decode step, rung 0
    throughout; 20b. phase 19d at Qwen3's width and 2 layers with
    ``QWEN3_B_LIMIT``;
21. Granite-3.0-MoE 3B-A800M at full width
    (``configs/granite_moe_3b_a800m.py``: 32 layers, d_model 1536, 24
    query heads over 8 KV heads of 64 (G = 3), 40 experts of 512 with
    top-8 routing, a tied head of 49,155): 21a. phase 16a at
    ``GRANITE_INT8_KN``, ``GRANITE_Q8_SHAPE`` and ``GRANITE_DECODE_SHAPE``,
    then #3's expert-batched instance ``int8_matmul_experts`` at
    ``EXPERT_CASES`` (Granite's and Phi-3.5-MoE's experts at their decode
    and prefill-chunk rows) bit for bit against its plain version, against
    per-expert launches of the 2-D entry and against a repeat, its fused
    entry too, each timed beside its bound, its plain version and E
    ``torch._int_mm`` calls (``check_int8_experts``); 21b. the dense engine
    at ``GRANITE_SERVE_LAYERS`` of its layers (random float32 weights from
    ``--seed``, freed once prepared; bf16 carrier, ``POLICY``), 16 slots of
    4096 rows, 32 requests in two waves of one prefill bucket each
    (``GRANITE.waves``: 16 of 1025-2048 prompt tokens, then 16 of
    129-256), 32 new each: exactly 4 #3, 3 ``int8_matmul_experts`` and one
    #12 a layer a decode step, 4 #3 and one #11 a layer a prefill launch
    and 3 ``int8_matmul_experts`` a layer a dispatch chunk of it
    (``serve_launches``), rung 0 throughout; 21c. the same requests paged
    (pages of 64 rows): 21b's tokens -- both engines prefill each wave in
    one launch, so every expert's capacity is taken by the same rows in
    the same order -- one #13 a layer a step, every page back; 21d. phase 16d at
    Granite's width and 2 layers, the CPU, the plain versions and the
    bf16-carrier control on the card's routes (``routes_replayed``), B
    within ``GRANITE_B_LIMIT``; each device routing on its own, the share
    of (token, k) routing choices that differ and the distance, reported
    (``cell_card_vs_cpu``);
22. Granite-3.0-MoE pre-training (the reference's ``local`` mode: the
    router, the capacity dispatch and its transpose, the experts' Fig-1
    linears on the expert-batched #3, #4 and #5, the combine, the aux and
    z losses): 22a. the expert-batched #4 ``int8_matmul_nt_experts`` and
    #5 ``int8_matmul_tn_experts`` at ``EXPERT_BWD_CASES`` (Granite's 40
    experts at training's C = 2,049, at 17 and at a ragged 1,001;
    Phi-3.5-MoE's 16 at 2,561) bit for bit against their plain versions,
    E launches of the 2-D entries and a repeat, each timed beside its
    bound, its plain version and E ``torch._int_mm`` calls, every GEMM
    kernel holding ``IGMMA`` (``check_int8_bwd_experts``); 22b.
    ``GRANITE_TRAIN_LAYERS`` of its 32 layers at full width (random
    weights from ``--seed``, bf16 carrier,
    ``TRAIN_POLICY`` with int moments, ``flash_pallas``, recomputation),
    2 x 4096 tokens a step for ``GRANITE_TRAIN_STEPS`` finite steps, each
    launching exactly ``train_launches``: 8 #3, 6 expert-batched #3, 4 #4
    and #5, 3 expert-batched #4 and #5, 2 #8, one #9 and one #10 a layer,
    one #6 (``train_granite``); 22c. at 4 layers, recomputation on against
    off and a repeat: ce and every gradient bit-identical, the peak lower
    (``granite_remat``); 22d. phase 8's checks at Granite's width and 2
    layers (4 x 128 tokens) on the card's routes within
    ``GRANITE_TRAIN_LIMITS``, the
    bf16-carrier control above them, every kernel's plain version on the
    card within them (``granite_train_card_vs_cpu``);
23. Mamba2-130M at full width and depth (``configs/mamba2_130m.py``: 24
    SSD layers, d_model 768, d_inner 1536 in 24 heads of 64, a state of
    128, a conv of width 4, a tied head of 50,280; no attention, no
    positions): 23a. #3 at the five projections' ``MAMBA_INT8_KN`` --
    in_dt's N = 24 the first output width on any path that is no multiple
    of 16: the cluster route's 32-column clusters run over 24 columns, the
    tensor-core route reads a zero-padded K-major copy -- and
    ``MAMBA_INT8_ROWS`` with phase 16a's gates (``check_int8_cell``); 23b. the dense engine (random float32 weights
    from ``--seed``, bf16 carrier, ``POLICY``: W8A8 prepared projections,
    no KV cache, the engine state the SSM and conv states), 16 slots of
    2048 rows, 32 requests in two waves of one prefill bucket (257-512,
    then 129-256 prompt tokens), 32 new each: exactly 120 #3 a decode step
    and a prefill launch and no other kernel, no KV cache, rung 0 (the
    one rung ``none``) throughout (``serve_cell``); 23c. phase 16d at
    Mamba2-130M's width and 2 layers with ``MAMBA_B_LIMIT`` and a
    bf16-carrier control above each limit (``cell_card_vs_cpu``);
24. Mamba2-130M pre-training: 24a. #4 and #5 at the five projections'
    training shapes (8,192 rows) bit for bit against their plain versions
    (``check_int8_bwd_ssm``); 24b. 24 layers at full width, 4 x 2048
    tokens a step (16 SSD chunks a row), ``TRAIN_POLICY`` with int
    moments, recomputation (one checkpoint a layer), ``MAMBA_TRAIN_STEPS``
    finite steps, each launching exactly 240 #3, 120 #4, 120 #5 and one
    #6 (``train_mamba2``); 24c. recomputation on against off and a repeat
    at full depth: ce and every gradient bit-identical, the peak lower
    (``mamba_remat``); 24d. phase 8's checks at Mamba2-130M's width and 2
    layers within ``MAMBA_TRAIN_LIMITS``, the bf16-carrier control above
    them, every kernel's plain version on the card within them
    (``mamba_train_card_vs_cpu``);
25. Zamba2-2.7B at full width (``configs/zamba2_2p7b.py``: 54
    Mamba2 layers, d_model 2560, and one attention + MLP block shared
    across the depth, run after every 6th layer -- 9 invocations, each with
    its own int8 KV cache -- on concat(h, the embedding), 5,120 wide: 32
    heads of 160, a gated GELU MLP of 10,240, a projection back to
    2,560): 25a. #3 at ``ZAMBA_INT8_KN`` x ``ZAMBA_INT8_ROWS``
    (``check_int8_cell``), #11 at ``ZAMBA_Q8_SHAPE`` and #12 / #13 at
    ``ZAMBA_DECODE_SHAPE``, their head-dim-160 instances, with phase 3's
    gates (``cell_kernels``); 25b. the dense engine (random float32
    weights from ``--seed``, bf16 carrier, ``POLICY``), 16 slots of 4096
    rows, ``ZAMBA_SERVE_LAYERS`` of its 54 layers, 32 requests in two
    waves of one prefill bucket each, 16 new tokens each: exactly 5 #3 a
    layer and 8 #3 and one #12 a shared-block call (152 #3 and 4 #12 at 24
    layers) a decode step, the same #3 and one #11 a call a prefill
    launch, the engine's state
    the int8 KV caches and the SSM states, rung 0 throughout
    (``serve_cell``); 25c. phase 16d at Zamba2's width and 12 layers (two
    groups: a cut below ``hybrid_attn_every`` would drop the shared block)
    with ``ZAMBA_B_LIMIT`` and a bf16-carrier control above each limit
    (``cell_card_vs_cpu``);
26. Zamba2-2.7B pre-training (the SSM layers' projections and the shared
    block's linears on #3, #4 and #5; the loss recomputing each group of
    six SSM layers and the shared block as two segments split at the
    shared block's attention context, as the reference's group checkpoint
    keeps ``attn_ctx``): 26a. #4 and #5 at ``ZAMBA_INT8_KN`` at 8,192
    rows (``check_int8_bwd``), and #8, #9 and #10 at the shared block's
    training attention (``ZAMBA_FLASH_SHAPE``: B 2, S 4096, 32 heads of
    160, causal, bf16; the backward on ``flash_bwd_sm90_wide.cu``) and at
    Gemma-2B's (``GEMMA_FLASH_SHAPE``: 8 heads of 256 over one KV head)
    within ``FLASH_BF16`` of their plain versions, a repeat bit-identical,
    each timed beside its bound and SDPA's forward and backward, #9 and
    #10 also beside ``flash_attn.cu``'s CUDA-core bodies at bf16 on the
    same inputs (``check_flash_train``); 26b. 54 layers at
    full width (random weights from ``--seed``, bf16 carrier,
    ``TRAIN_POLICY`` with int moments, ``flash_pallas``), 2 x 4096 tokens
    a step for ``ZAMBA_TRAIN_STEPS`` finite steps, each launching exactly
    ``train_launches``: 684 #3, 342 #4, 342 #5, one #6, 18 #8, 9 #9 and 9
    #10, the backward's library the tensor-core ``flash_bwd_sm90_wide``
    (``train_zamba2``); 26c. the same step under ``_attend``
    (``attention_impl="xla"``) at ``ZAMBA_XLA_LAYERS`` layers,
    ``ZAMBA_XLA_STEPS`` finite steps and no
    flash launch (``train_zamba2_xla``); 26d. at 12 layers (two groups),
    recomputation on against off and a repeat: ce and every gradient
    bit-identical, the peak lower (``zamba_remat``); 26e. phase 8's checks
    at Zamba2's width and 12 layers within ``ZAMBA_TRAIN_LIMITS``, the
    bf16-carrier control above them, every kernel's plain version on the
    card within them (``zamba_train_card_vs_cpu``);
27. seamless-m4t-medium served (``configs/seamless_m4t_medium.py``: 12
    encoder and 12 decoder layers, d_model 1024, 16 heads of 64, a classic
    GELU MLP of 4096 with biases, LayerNorm, RoPE, an untied head over
    256,206 tokens; the audio frontend a stub, precomputed frames through
    ``frame_proj``), through ``train.serve.greedy_generate``, which sends
    the family to the reference's prefill-then-decode loop: 27a. at 2 + 2
    layers, full width and vocab, float32 carrier, ``flash_pallas``, the
    card's greedy run against the CPU's on the same weights within
    ``SEAMLESS_B_LIMIT``, the plain #3 bit-identical, the bf16-carrier
    control beyond the limit (``seamless_serve_card_vs_cpu``); 27b. 12 +
    12 layers (random weights from ``--seed``, bf16 carrier,
    ``FLASH_SERVE_POLICY``, ``flash_pallas``): 8 rows of 1,024 frames, a
    64-token prompt, 32 new tokens; exactly 3,265 #3, 12 #7 non-causal on
    the encoder and 12 #7 causal on the prompt, prefill and decode times,
    tokens/s, peak memory and a profiled decode step
    (``serve_seamless``);
28. seamless-m4t-medium pre-trained: 28a. #8, #9 and #10 at a step's
    cross-attention (4 x 16 heads, Sq 2,048 over Skv 512, non-causal)
    within ``FLASH_BF16`` of their plain versions, a repeat bit-identical,
    each timed beside its bound and SDPA (``check_seamless_flash``); then
    12 + 12 layers at full width,
    4 x 2,048 decoder tokens over 512 frames a step, ``TRAIN_POLICY`` with
    int moments, ``flash_pallas``, recomputation (each block one
    checkpoint), ``SEAMLESS_TRAIN_STEPS`` finite steps, each launching
    exactly 385 #3, 193 #4, 193 #5, one #6, 72 #8, 36 #9 and 36 #10 --
    #8-#10 non-causal on the encoder's self-attention and on the
    cross-attention at Sq 2,048 > Skv 512 (``train_seamless``); 28b. at 4
    + 4 layers, recomputation on against off and a repeat: ce and every
    gradient bit-identical, the peak lower (``seamless_remat``); 28c.
    phase 8's checks at 2 + 2 layers, full width and vocab, within
    ``SEAMLESS_TRAIN_LIMITS``, the bf16-carrier control above them, every
    kernel's plain version on the card within them
    (``seamless_train_card_vs_cpu``).

The CPU sides of the larger card-vs-CPU checks (16d, 18d, 19d, 20b, 23c,
24d, 25c, 26e, 27a and 28c: their weights drawn on the CPU and the CPU's
run) are computed by a worker process started after the build
(``CpuHalves``, ``cpu_jobs``), at the main process's torch thread count,
while the card runs the phases before them; each check prints its split
(``print_split``).

Phases 7, 10, 11 and 14 pin ``remat=False`` (``gpt2_train_cfg``), so
their launch gates (72 #3 a step) and their numbers keep their meaning;
their CE chunks are checkpointed, as in the reference.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside it, it exits with 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_cuda"
# H100 SXM published peaks (NVIDIA data sheet), dense: HBM3 bytes/s, int8
# tensor-core ops/s, bf16 tensor-core FLOP/s, fp32 FLOP/s outside the
# tensor cores
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
SERVE_KERNELS = ("int8_matmul", "flash_attention_fwd_q8", "decode_attention",
                 "int8_matmul_experts")
TRAIN_KERNELS = ("int8_matmul_nt", "int8_matmul_tn", "fused_adamw_leaves",
                 "int8_matmul_nt_experts", "int8_matmul_tn_experts")
QDQ_KERNELS = ("qdq_row", "qdq_scaled")
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
KERNEL_NAMES = SERVE_KERNELS + TRAIN_KERNELS + ("fused_adamw_blocks",) \
    + ("decode_attention_paged",) \
    + QDQ_KERNELS + FLASH_KERNELS
#: phases 4 and 4b: 32 requests, prompts of 32-512 tokens, 64 new tokens
#: each, 16 slots of 1024 rows; 4b's pages hold 64 rows, its requests
#: arrive with exponential gaps of this mean
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_SEQ = 32, 64, 16, 1024
PAGE, ARRIVAL_MEAN_S = 64, 0.02
#: the training path's policy: paper Section 4.5's W8/A8/G8 on the int8
#: kernels, Adam moments stored blockwise in 8 bits
TRAIN_POLICY = "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda"
TRAIN_STEPS = 10
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
#: phase 10: the fake-quant recipes whose G spec runs the qdq kernels
FAKE_RECIPES = ("paper_wag8", "w8c,a8t,g8n", "w8c,a8t,g8c")
#: phase 11: the guarded path -- the sentinel's settings, the checkpoint
#: period, the fault plan and the number of loop steps
LADDER_SENTINEL = dict(window=8, min_history=2, skip_limit=1,
                       fallback_steps=4, max_rollbacks=3)
LADDER_STEPS, LADDER_CKPT_EVERY, LADDER_FAULT = 12, 3, "nan_grad@5"
#: the ladder that plan walks: the verdict at each loop step in order (the
#: NaN step skips, the fault fires again at the next loop step because a
#: skipped step does not advance the optimizer's counter, and the second
#: spike rolls back to the checkpoint of step 3), the loop's and the
#: sentinel's counts, the history rows run in the fallback window and the
#: spike reasons.  tests/test_torch_train_system.py holds it equal to the
#: JAX Trainer's on the same plan and settings.
LADDER_EXPECT = {
    "verdicts": [[0, "ok"], [1, "ok"], [2, "ok"], [3, "ok"], [4, "ok"],
                 [5, "skip"], [6, "rollback"], [3, "ok"], [4, "ok"],
                 [5, "ok"], [6, "ok"], [7, "ok"], [8, "ok"], [9, "ok"],
                 [10, "ok"], [11, "ok"]],
    "counts": {"saves": 4, "restores": 1, "skipped_batches": 1,
               "rollback_failures": 0, "observed": 16, "spikes": 2,
               "skips": 1, "rollbacks": 1, "fallback_windows": 1,
               "fallback_steps_run": 7},
    "fallback_rows": [4, 5, 6, 7, 8, 9, 10],
    "spike_reasons": {"nonfinite-grad": 2},
}
#: phase 17: the serving degradation ladder.  17a serves under a KV spec
#: no kernel takes (per tensor), so rung 0 is dequantize-on-read; 17c walks
#: the ladder of ``POLICY`` under ``SERVE_LADDER_PLAN`` with the monitor's
#: re-probe after ``SERVE_LADDER_REPROBE`` healthy steps, on the first
#: ``SERVE_LADDER_REQUESTS`` of 17a's prompts; 17d drains the paged pool
#: under ``SERVE_OOM_PLAN``.  17a's and 17c's prompts all lie in the
#: prefill bucket of ``LADDER_PROMPT_LENS`` (one page multiple), so a
#: request's prefill write block and its slot are the same in the dense and
#: the paged engine, and their tokens must be equal for every request
DEQUANT_POLICY = "kv_cache=a8n,*=w8c+a8t@int8_cuda"
SERVE_LADDER_PLAN = ("kernel_error@4;kernel_error@6;nan_logit@26:slot=0;"
                     "nan_logit@27:slot=1;slow_step@40:ms=20")
SERVE_LADDER_REPROBE = 8
SERVE_LADDER_REQUESTS = 16
LADDER_PROMPT_LENS = (257, 512)
SERVE_OOM_PLAN = "oom_pages@10:hold=2"
#: the walk that plan takes, (decode step, from rung, to rung) in step
#: order: the two kernel errors demote twice, 8 healthy steps promote
#: twice, the second quarantine inside the numeric window demotes once
#: more and 8 healthy steps promote again.
#: tests/test_torch_serve_ladder.py holds it equal to the JAX engine's walk
#: on the same plan and monitor settings.
SERVE_LADDER_EXPECT = [[4, "fused", "dequant"], [6, "dequant", "fp"],
                       [13, "fp", "dequant"], [21, "dequant", "fused"],
                       [27, "fused", "dequant"], [35, "dequant", "fused"]]
#: phase 17b: limit on max |d logit| of the dequantize-on-read rung against
#: the fused rung on the card (an a8t model, float32 carrier,
#: ``true_fan_in`` weights), set from readings at seeds 0-3
#: (``tools/dequant_readings.py``, PERF.md): 6.0e-4 to 2.07e-3, the
#: bf16-carrier control 2.91e-2 to 3.20e-2; the limit sits 3.9x above the
#: largest reading and 3.6x below the smallest control, which must exceed it
DEQUANT_FUSED_LIMIT = 8e-3


def serve_walk(summary):
    """A serving engine's ladder transitions from its
    ``resilience_summary()``, as ``SERVE_LADDER_EXPECT`` lists them; the
    same for the port's engine and the JAX package's."""
    moves = summary["demotions"] + summary["promotions"]
    return [[d["step"], d["from"], d["to"]]
            for d in sorted(moves, key=lambda d: d["step"])]


#: phase 13: the flash kernels at the training shape (BH = 8 x 12 heads,
#: S = 1024, hd = 64, causal), then this sweep: (label, BH, Sq, Skv, hd,
#: causal, q_offset) -- every other head dim of the repo's configs, Sq !=
#: Skv at q_offset = Skv - Sq, an odd length, the non-causal case, the
#: fp-KV prefill's 300-token prompt against a 1024-row cache and
#: seamless-m4t-medium's cross-attention in training (B 4 x 16 heads,
#: 2,048 decoder rows over 512 encoder frames, non-causal: Sq > Skv)
FLASH_SWEEP = (("hd16", 16, 512, 512, 16, True, 0),
               ("hd32", 16, 512, 512, 32, True, 0),
               ("hd128", 16, 512, 512, 128, True, 0),
               ("hd160", 8, 512, 512, 160, True, 0),
               ("hd256", 8, 512, 512, 256, True, 0),
               ("offset", 16, 384, 1024, 64, True, 640),
               ("odd", 16, 1000, 1000, 64, True, 0),
               ("noncausal", 16, 512, 700, 64, False, 0),
               ("prefill", 12, 300, 1024, 64, True, 0),
               ("cross", 64, 2048, 512, 64, False, 0))
#: phase 13's tolerances of the kernels against their plain versions on
#: the same unit-normal inputs (the backward's plain versions read the
#: kernels' lse and delta): o's max |error| by carrier and the LSE rows'
#: (the reference's own, tests/test_flash_attn.py), and at float32 the
#: gradients' relative L2 distance.  At bfloat16 the kernels and the plain
#: versions compute one fp32 function in another order and round it once,
#: so o, dq, dk and dv are held to FLASH_BF16: their relative L2 distance
#: and the share of elements more than one bf16 step from the plain
#: version.  The plain forward rounds p against the running max of the
#: kernel's key tiles, as the kernel does, and sums each score in float64
#: before rounding it to fp32; the plain backward sums its five products
#: in float64, and delta (sum(dO * o), an input of both) is summed in
#: float64 too (_flash_all), so that nothing compared carries an fp32
#: summation order of its own (cuBLAS's fp32 order alone lies up to 1.6e-4
#: rel L2 and 4.8e-4 over one step from the forward's, PERF.md; with delta
#: summed in fp32, dq's row 0 under the causal mask is rounding noise).
#: Five controls that move one rounding of p or ds must exceed both
#: limits: the plain forward with p left unrounded, the plain forward
#: rounding p against the row's final max (the reference's _ref_attend),
#: #9's dv with p rounded to bf16, and #9's dk and #10's dq with ds rounded
#: to bf16.
#: Readings on the H100 at every phase-13 shape (PERF.md, call 3 of PR
#: 18): o from the tensor-core forward at most 1.35e-4 and 1.35e-4, dq, dk
#: and dv from the tensor-core backward at most 6.25e-5 and 3.24e-5 (the
#: plain backward with fp32 sums: 6.78e-5 and 3.43e-5), controls at least
#: 9.26e-4 and 3.42e-2; the rel L2 limit sits 1.5x above the largest sound
#: reading and 4.6x below the smallest control, the step limit 7.4x and
#: 34x.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_LSE_TOL = 2e-5
FLASH_GRAD_TOL = 1e-4
FLASH_BF16 = {"rel_l2": 2e-4, "over_ulp": 1e-3}
#: phase 13's NaN check: hd 64 (``flash_bwd_sm90.cu``) and one head dim of
#: each instance of ``flash_bwd_sm90_wide.cu`` (192 and 256 columns)
FLASH_NAN_HEAD_DIMS = (64, 160, 256)
#: phase 14b: the flash prefill serves 8 of phase 4's prompts, 16 new
#: tokens each, from an fp KV cache (no kv_cache role)
FLASH_SERVE_POLICY = "*=w8c+a8t@int8_cuda"
FLASH_SERVE_REQUESTS, FLASH_SERVE_NEW = 8, 16
#: phase 15: limits of flash against flash (card vs CPU) and of flash
#: against _attend (the same function in another fp32 order), stated
#: before any reading: |d ce|, the gradients' relative L2 distance, max
#: |d logit|
FLASH_LIMITS = {"ce": 1e-5, "grads": 1e-4, "logits": 1e-4}
# phase 5, policy B: limit on max |d logit| of the card against the CPU, set
# from the readings recorded in PERF.md (not sized at run time)
B_LIMIT = 0.1
# phase 8, A: limits of the card against the CPU for one train step, set
# from the readings at seeds 0-5 recorded in PERF.md (not sized at run
# time): |d ce| (readings 1.0e-5 to 1.1e-4), the gradients' relative L2
# distance (1.0e-2 to 1.4e-2), the share of elements whose gradient sign
# differs (2.6e-3 to 4.0e-3) and the parameter updates' relative L2 distance
# where the sign agrees (5.3e-3 to 5.8e-3).  Adam's first step is nearly
# sign(g), so each sign flip moves its update by about 2 lr and the updates
# as a whole part by about 2 sqrt(share): 9.6e-2 to 1.22e-1, held to
# 2 sqrt(1e-2), the sign-flip limit's worth.
TRAIN_LIMITS = {"ce": 1e-3, "grads": 5e-2, "sign_flips": 1e-2,
                "updates_sign": 2e-2, "updates": 0.2}


def ladder_record(summary, history, verdicts):
    """The parts of a guarded run that ``LADDER_EXPECT`` pins, from a
    Trainer's ``resilience_summary()``, its history and the sentinel's
    verdicts as (loop step, verdict value) pairs; the same for the port's
    Trainer and the JAX package's."""
    s = summary["sentinel"]
    counts = {k: summary[k] for k in ("saves", "restores", "skipped_batches",
                                      "rollback_failures")}
    counts.update({k: s[k] for k in ("observed", "spikes", "skips",
                                     "rollbacks", "fallback_windows",
                                     "fallback_steps_run")})
    return {"verdicts": [[int(st), str(v)] for st, v in verdicts],
            "counts": counts,
            "fallback_rows": [int(r["step"]) for r in history
                              if r.get("fallback")],
            "spike_reasons": dict(s["spike_reasons"])}


def bound_ms(nbytes: float, ops: float, rate: float):
    """Least time for the work: the larger of bytes over memory rate and
    operations over peak rate; returns (ms, 'bytes' | 'operations')."""
    t_mem = nbytes / HBM_BPS
    t_ops = ops / rate
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def healthy(eng, label: str) -> None:
    """A serving phase on the healthy path: no decode step failed, the
    ladder never moved and rung 0 ran to the end (the ladder must not hide
    a failing kernel)."""
    s = eng.resilience_summary()
    if s["kernel_errors"] or s["demotions"] or s["rung_index"]:
        fail(f"{label}: the healthy path degraded: kernel_errors "
             f"{s['kernel_errors']}, demotions {s['demotions']}, rung "
             f"{s['rung']} ({s['rung_index']})")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")


#: phase 3: the forward's shapes -- the decode step's 16 slots, M = 17, 32
#: and 64 past the cluster route's limit, a prefill of 2048 rows and the
#: training step's 8192 tokens -- at GPT-2 small's three (K, N), bf16
#: output; and float32 output at (768, 768)
INT8_FWD_ROWS = (16, 17, 32, 64, 2048, 8192)
INT8_FWD_KN = ((768, 768), (768, 3072), (3072, 768))
#: the decode step's 72 weights: per layer wq, wk, wv and wo (768, 768), w1
#: (768, 3072) and w2 (3072, 768) -- 85 MB, more than the 50 MB L2
DECODE_STEP_KN = ((768, 768),) * 4 + ((768, 3072), (3072, 768))
#: the fused decode entry's rows: one slot, a ragged count, all 16 slots
INT8_QUANT_ROWS = (1, 7, 16)


def _int8_case(torch, dev, gen, m, k, n):
    """int8 payloads x (m, k), w (k, n) and scales rs (m, 1), cs (1, n),
    every 7th row scale 0 (the guard maps it to 1)."""
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    rs = torch.rand((m, 1), generator=gen, device=dev) * 0.05
    cs = torch.rand((1, n), generator=gen, device=dev) * 0.01
    rs[::7] = 0.0
    return x, w, rs, cs


def check_int8_matmul(torch, dev, gen, results):
    """Phase 3, #3: the wrapper (its route by ``fwd_route``), both routes --
    the cluster's split-K weight stream (M <= ``FWD_GEMV_MAX_M``) and the
    tensor-core one (transpose pass + s8 wgmma GEMM) -- and the first dp4a
    kernel, bit for bit against the plain version at every shape and output
    dtype, the cluster route's repeat bit-identical; each timed call by call
    and with the card's queue full (``queued_ms``), every route at every M it
    takes, beside the bound, the plain version and ``torch._int_mm``
    (queued; it takes M > 16 only, so at M = 16 on x zero-padded to 17
    rows).  At M = 16: the cluster sizes 1-8 queued, and a round over the
    decode step's 72 distinct weights (``DECODE_STEP_KN``, the L2 cold) per
    call.  The fused entry ``int8_quant_matmul`` bit for bit against its
    plain version at ``INT8_QUANT_ROWS``, both carriers, an all-zero row
    included, and on rows holding a NaN or an infinity, timed against the
    unfused chain.  The forward's GEMM kernels hold ``IGMMA`` in their
    SASS, the cluster kernels ``IMMA``."""
    import importlib
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    from repro_torch.core.qconfig import Granularity, QuantSpec
    from repro_torch.core.quantizer import quantize_int
    rows = []
    cases = [(m, k, n, torch.bfloat16) for m in INT8_FWD_ROWS
             for k, n in INT8_FWD_KN]
    cases += [(m, 768, 768, torch.float32) for m in INT8_FWD_ROWS]
    for m, k, n, dt in cases:
        x, w, rs, cs = _int8_case(torch, dev, gen, m, k, n)
        want = im.int8_matmul_plain(x, w, rs, cs, out_dtype=dt)
        route = im.fwd_route(m, n, k)
        routes = {"wgmma": im.int8_matmul_wgmma, "dp4a": im.int8_matmul_dp4a}
        if m <= im.FWD_GEMV_MAX_M:
            routes["gemv"] = im.int8_matmul_gemv
        got = {"wrapper": im.int8_matmul(x, w, rs, cs, out_dtype=dt),
               **{r: f(x, w, rs, cs, dt) for r, f in routes.items()}}
        if "gemv" in routes:
            got["gemv repeat"] = im.int8_matmul_gemv(x, w, rs, cs, dt)
        torch.cuda.synchronize()
        err = max((g.float() - want.float()).abs().max().item()
                  for g in got.values())
        for name, g in got.items():
            if not torch.equal(g, want):
                fail(f"int8_matmul ({name}) M={m} K={k} N={n} {dt} not "
                     f"bit-exact (max err {err})")
        route_ms = {r: queued_ms(lambda f=f: f(x, w, rs, cs, dt))
                    for r, f in routes.items()}
        call_ms = {r: time_ms(lambda f=f: f(x, w, rs, cs, dt))
                   for r, f in routes.items()}
        plain = time_ms(lambda: im.int8_matmul_plain(x, w, rs, cs, dt),
                        iters=3)
        # torch._int_mm (int8 x int8 -> int32, no epilogue) takes M > 16:
        # at M <= 16 it runs on x zero-padded to 17 rows, padded here
        xl = (x if m > 16 else torch.nn.functional.pad(x, (0, 0, 0, 17 - m)))
        lib = queued_ms(lambda: torch._int_mm(xl, w))
        es = 2 if dt == torch.bfloat16 else 4
        b, by = bound_ms(m * k + k * n + 4 * (m + n) + es * m * n,
                         2.0 * m * n * k, INT8_OPS)
        row = dict(
            shape=f"M={m},K={k},N={n},{str(dt)[6:]}", fwd_route=route,
            max_abs_err=err, ms=route_ms[route], ms_call=call_ms[route],
            route_ms=route_ms, route_ms_call=call_ms,
            splits=im.gemm_splits(m, n, k), plain_ms=plain, bound_ms=b,
            bound_by=by, library_ms=lib,
            library="torch._int_mm" + ("" if m > 16 else
                                       " on x zero-padded to 17 rows"))
        if m == 16 and dt == torch.bfloat16:
            row["gemv_splits_ms"] = {
                s: queued_ms(lambda s=s: im.int8_matmul_gemv(
                    x, w, rs, cs, dt, splits=s))
                for s in (1, 2, 4, 8)}
        rows.append(row)
        line = "; ".join(f"{r} {route_ms[r]:.4f} / {call_ms[r]:.4f}"
                         for r in routes)
        print(f"int8_matmul M={m:5d} K={k:4d} N={n:4d} {str(dt)[6:]}: "
              f"bit-exact on every route (tol 0), route {route}; queued / "
              f"call by call ms: {line} ({im.gemm_splits(m, n, k)} GEMM "
              f"split(s)); plain_ms {plain:.4f}, bound_ms {b:.5f} ({by}), "
              f"library_ms ({row['library']}, queued) {lib:.4f}")
        if "gemv_splits_ms" in row:
            print(f"int8_matmul M=16 K={k} N={n}: cluster sizes, queued ms "
                  + ", ".join(f"{s}: {t:.4f}"
                              for s, t in row["gemv_splits_ms"].items()))
    cold = _int8_decode_round(torch, dev, gen, im)
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    fused = _int8_quant_check(torch, dev, gen, im, spec, quantize_int)
    host = _int8_host_us(torch, dev, gen, im, spec, quantize_int)
    counts = sass_counts("int8_matmul", "IGMMA")
    gemm = {fn: c for fn, c in counts.items() if "gemm_s8_kernel" in fn}
    print(f"int8_matmul SASS: {sum(gemm.values())} IGMMA instructions over "
          f"{len(gemm)} GEMM kernels (each "
          f"{min(gemm.values(), default=0)}-{max(gemm.values(), default=0)})")
    if not gemm or min(gemm.values()) == 0:
        fail(f"phase 3: a forward GEMM kernel has no IGMMA: {gemm}")
    gv = {fn: c for fn, c in sass_counts("int8_matmul", "IMMA").items()
          if "gemv_s8_kernel" in fn}
    print(f"int8_matmul SASS: {sum(gv.values())} IMMA instructions over "
          f"{len(gv)} cluster kernels (each "
          f"{min(gv.values(), default=0)}-{max(gv.values(), default=0)})")
    if not gv or min(gv.values()) == 0:
        fail(f"phase 3: a cluster kernel has no IMMA: {gv}")
    # the JSON entry reports the shape with the most launches on the main
    # path: the decode step's wq, wk, wv and wo at M = 16 slots (4 of every
    # 6 decode launches); kernels.json keeps every shape
    results["int8_matmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:84", tol=0.0,
        shapes=rows, l2_cold=cold, fused_entry=fused, host_us=host, **rows[0])


def _int8_decode_round(torch, dev, gen, im):
    """The decode step's 72 weights at M = 16, each its own buffer (85 MB
    together, so every call finds its weight out of the L2): ms per call
    over the round for the cluster route, the first dp4a kernel and the
    tensor-core route, back to back and queued, beside the round's bound."""
    args = []
    for _ in range(12):
        for k, n in DECODE_STEP_KN:
            x, w, rs, cs = _int8_case(torch, dev, gen, 16, k, n)
            args.append((x, w, rs, cs, torch.bfloat16))
    nbytes = sum(x.numel() + w.numel() + 4 * (16 + w.shape[1])
                 + 2 * 16 * w.shape[1] for x, w, *_ in args)
    out = {"weights": len(args), "weight_bytes": sum(a[1].numel()
                                                     for a in args),
           "bound_ms": nbytes / HBM_BPS * 1e3 / len(args)}
    for r, f in (("gemv", im.int8_matmul_gemv), ("dp4a", im.int8_matmul_dp4a),
                 ("wgmma", im.int8_matmul_wgmma)):
        out[r] = {"ms_call": time_cold_ms(f, args, 2 * len(args), len(args)),
                  "ms": time_cold_ms(f, args, 2 * len(args), len(args),
                                     queued=True)}
    print(f"int8_matmul L2 cold, a round over the decode step's "
          f"{len(args)} weights ({out['weight_bytes'] / 1e6:.1f} MB) at M = "
          f"16, ms per call queued / call by call: "
          + "; ".join(f"{r} {out[r]['ms']:.4f} / {out[r]['ms_call']:.4f}"
                      for r in ("gemv", "dp4a", "wgmma"))
          + f"; bound {out['bound_ms']:.5f} (bytes)")
    return out


def host_us(fn, iters: int = 500, warmup: int = 20) -> float:
    """Host microseconds per call: the host clock around ``iters`` calls,
    which the card keeps up with (each call's kernels are shorter than its
    dispatch), then one synchronize outside the window."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _int8_host_us(torch, dev, gen, im, spec, quantize_int):
    """Where a decode linear's host time goes, at M = 16, (768, 3072), bf16:
    the fused entry, the unfused chain and the cluster route's wrapper, and
    the stream lookup every wrapper makes (``_build.stream_of`` against a
    ``torch.cuda.Stream`` object's handle)."""
    from repro_torch.kernels import _build
    x, w, rs, cs = _int8_case(torch, dev, gen, 16, 768, 3072)
    xf = torch.randn((16, 768), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.bfloat16

    def chain():
        xq, sc, _ = quantize_int(xf, spec)
        return im.int8_matmul(xq, w, sc, cs, dt)
    out = {"int8_quant_matmul": host_us(
               lambda: im.int8_quant_matmul(xf, w, cs, spec, dt)),
           "quantize_int + int8_matmul": host_us(chain),
           "int8_matmul_gemv": host_us(
               lambda: im.int8_matmul_gemv(x, w, rs, cs, dt)),
           "_build.stream_of": host_us(lambda: _build.stream_of(x)),
           "torch.cuda.current_stream(dev).cuda_stream": host_us(
               lambda: torch.cuda.current_stream(dev).cuda_stream)}
    print("int8_matmul host us per call at M = 16, K = 768, N = 3072: "
          + "; ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def _int8_quant_check(torch, dev, gen, im, spec, quantize_int):
    """The fused decode entry at ``INT8_QUANT_ROWS`` x GPT-2's three (K, N)
    x both carriers, an all-zero row wherever M > 1: bit for bit against
    ``int8_quant_matmul_plain`` (quantize_int + the plain matmul), a
    repeat bit-identical; at M = 16 timed queued and call by call, and the
    unfused chain (quantize_int + int8_matmul) call by call.  Then at M = 16
    rows holding a NaN, +inf, -inf, or a NaN and an inf, against the plain
    version: NaN where it has NaN, the same bits elsewhere."""
    out = []
    for m in INT8_QUANT_ROWS:
        for k, n in INT8_FWD_KN:
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn((m, k), generator=gen, device=dev)
                     * 3).to(dt)
                if m > 1:
                    x[m // 2] = 0.0
                _, w, _, cs = _int8_case(torch, dev, gen, m, k, n)
                want = im.int8_quant_matmul_plain(x, w, cs, spec, dt)
                got = im.int8_quant_matmul(x, w, cs, spec, dt)
                again = im.int8_quant_matmul(x, w, cs, spec, dt)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(again, got)):
                    fail(f"int8_quant_matmul M={m} K={k} N={n} {dt}: not "
                         f"bit-exact or a repeat differs (max err "
                         f"{(got.float() - want.float()).abs().max().item()})")
                if m != 16:
                    continue

                def chain():
                    xq, sc, _ = quantize_int(x, spec)
                    return im.int8_matmul(xq, w, sc, cs, dt)
                fused = (lambda: im.int8_quant_matmul(x, w, cs, spec, dt))
                row = dict(shape=f"M={m},K={k},N={n},{str(dt)[6:]}",
                           ms=queued_ms(fused), ms_call=time_ms(fused),
                           chain_ms_call=time_ms(chain))
                out.append(row)
                print(f"int8_quant_matmul {row['shape']}: bit-exact (tol 0) "
                      f"at M = {', '.join(map(str, INT8_QUANT_ROWS))}, a "
                      f"repeat bit-identical; fused ms queued {row['ms']:.4f}"
                      f", call by call {row['ms_call']:.4f}; quantize_int + "
                      f"int8_matmul call by call {row['chain_ms_call']:.4f}")
    bad = {3: [(767, float("nan"))], 5: [(0, float("inf"))],
           9: [(384, float("-inf"))],
           11: [(1, float("nan")), (2, float("inf"))]}
    for k, n in INT8_FWD_KN:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((16, k), generator=gen, device=dev) * 3).to(dt)
            for r, cells in bad.items():
                for c, v in cells:
                    x[r, c * k // 768] = v
            _, w, _, cs = _int8_case(torch, dev, gen, 16, k, n)
            want = im.int8_quant_matmul_plain(x, w, cs, spec, dt)
            got = im.int8_quant_matmul(x, w, cs, spec, dt)
            same = (got == want) | (got.isnan() & want.isnan())
            if not (bool(same.all()) and bool(got[[3, 11]].isnan().all())):
                fail(f"int8_quant_matmul K={k} N={n} {dt}: rows holding a "
                     f"NaN or an infinity differ from the plain version")
    print("int8_quant_matmul: rows holding a NaN or an infinity match the "
          "plain version (NaN where it has NaN, the same bits elsewhere) at "
          "M = 16, GPT-2's three (K, N), both carriers")
    return out


def _int8_cache(torch, dev, gen, b, s, kh, hd, lengths):
    """Ragged int8 cache: rows < lengths[i] hold quantized random K/V, the
    rest the never-written state (payload 0, scale 0)."""
    from repro_torch.core.qconfig import Granularity, QuantSpec
    from repro_torch.core.quantizer import quantize_int
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    valid = (torch.arange(s, device=dev)[None, :, None, None]
             < torch.as_tensor(lengths, device=dev)[:, None, None, None])
    out = []
    for _ in range(2):
        q, sc, _ = quantize_int(torch.randn((b, s, kh, hd), generator=gen,
                                            device=dev), spec)
        out += [torch.where(valid, q, torch.zeros_like(q)).contiguous(),
                torch.where(valid, sc, torch.zeros_like(sc)).contiguous()]
    return out        # kq, ks, vq, vs


def attention_err(torch, got, want) -> float:
    """Max |kernel - plain| of an attention output.  At the float32 carrier
    the caller holds it to the stated tolerance; at bfloat16 two fp32
    results a few ulp apart may round to neighbouring bf16 values, so each
    element must be within one bf16 rounding step (or 1e-5, where
    cancellation leaves a value too small for that step to cover fp32
    noise)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    d = (g - w).abs()
    step = torch.clamp(torch.maximum(g.abs(), w.abs()) * 2.0 ** -7, min=1e-5)
    if got.dtype == torch.bfloat16 and not bool((d <= step).all()):
        fail(f"bf16 attention output off by more than one bf16 step "
             f"(max err {d.max().item()})")
    return d.max().item()


def _dequant(torch, q, s):
    from repro_torch.kernels.int8_matmul import scale_guard
    return q.float() * scale_guard(s)


def _decode_pos(torch, dev, gen, b, s):
    """Phase 3's ragged positions: pos 0 (slot 0), a full slot (pos == S,
    the clamped write), the kernel's chunk edges 1, C - 1, C, C + 1 and S -
    1, the rest drawn from [1, S)."""
    from repro_torch.kernels.decode_attn import DECODE_CHUNK as c
    pos = torch.randint(1, s, (b,), generator=gen, device=dev)
    edges = [0, s, 1, c - 1, c, c + 1, s - 1]
    pos[:len(edges)] = torch.tensor(edges, device=dev)
    return pos.to(torch.int32)


def _decode_times(torch, fn, plain, sdpa, nbytes, ops):
    """#12 / #13 timed queued and call by call, its plain version, SDPA
    queued and call by call, and the bound."""
    bd, by = bound_ms(nbytes, ops, FP32_FLOPS)
    return dict(ms=queued_ms(fn), ms_call=time_ms(fn),
                plain_ms=time_ms(plain, iters=5), bound_ms=bd, bound_by=by,
                library_ms=queued_ms(sdpa), library_ms_call=time_ms(sdpa))


def _decode_cost(q, nk, pos, kh, hd, g, extra=0):
    """Bytes (each live cache row's payloads and scales, q and ctx, the
    new rows read, the written row, pos; ``extra`` more) and fp32 FLOPs of
    one decode step."""
    b = q.shape[0]
    rows = pos.clamp(0, None).long()
    row_bytes = kh * (hd + 4)
    nbytes = (2 * int(rows.sum()) * row_bytes + 2 * q.numel() * 2
              + 2 * nk.numel() * 2 + 2 * b * row_bytes + 4 * b + extra)
    return nbytes, 4.0 * hd * g * kh * float((rows + 1).sum())


def _sdpa_yardstick(torch, dev, q, kq, ks, vq, vs, pos):
    """SDPA over K/V dequantized beforehand, the KV heads expanded to the
    query heads (neither timed), the decode step's valid rows unmasked."""
    import torch.nn.functional as F
    b, kh, g, hd = q.shape
    s = kq.shape[1]
    # the KV heads expanded to the query heads (KV-major groups)
    kd = _dequant(torch, kq, ks).bfloat16().permute(0, 2, 1, 3
                                                    ).repeat_interleave(g, 1)
    vd = _dequant(torch, vq, vs).bfloat16().permute(0, 2, 1, 3
                                                    ).repeat_interleave(g, 1)
    qs = q.reshape(b, kh * g, 1, hd)
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None].clamp(min=1)
            )[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)


def _time_line(t) -> str:
    return (f"queued ms {t['ms']:.4f} (call by call {t['ms_call']:.4f}), "
            f"plain_ms {t['plain_ms']:.4f}, bound_ms {t['bound_ms']:.5f} "
            f"({t['bound_by']}), library_ms(SDPA, queued) "
            f"{t['library_ms']:.4f} (call by call {t['library_ms_call']:.4f})")


#: #12 / #13's shapes (B, S, K, G, hd): GPT-2 small's decode step (phase
#: 3) and Yi-6B's (phase 16: 8 query heads of 128 a KV head)
DECODE_SHAPE = (16, 1024, 12, 1, 64)
YI_DECODE_SHAPE = (16, 4096, 4, 8, 128)


def _store(results, name, tag, entry):
    """A kernel's entry in ``results``: phase 3's the entry itself, a later
    phase's under its ``tag`` inside it (kernels.json keeps both)."""
    if tag:
        results[name][tag] = entry
    else:
        results[name] = entry


def check_decode_attention(torch, dev, gen, results, shape=DECODE_SHAPE,
                           tag=None):
    """Phase 3, #12 at GPT-2 small's decode widths (16 slots of 1024 rows,
    12 kv heads of 64; phase 16: ``YI_DECODE_SHAPE``) at ``_decode_pos``'s
    positions: ctx within 1e-3 of the plain version at float32 (within one
    bf16 step at bfloat16), the written rows bit for bit, a second launch
    on a clone of the same cache bit-identical in ctx and written rows;
    timed queued and call by call beside SDPA."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain)
    b, s, kh, g, hd = shape
    pos = _decode_pos(torch, dev, gen, b, s)
    cache = _int8_cache(torch, dev, gen, b, s, kh, hd, pos)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).bfloat16()
    nk = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    nv = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        kc = [t.clone() for t in cache]
        pc = [t.clone() for t in cache]
        rc = [t.clone() for t in cache]
        args = [t.to(dt) for t in (q, nk, nv)]
        got = decode_attention(args[0], *kc, *args[1:], pos)
        want = decode_attention_plain(args[0], *pc, *args[1:], pos)
        again = decode_attention(args[0], *rc, *args[1:], pos)
        errs[dt] = attention_err(torch, got, want)
        for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, pc):
            if not torch.equal(a, c):
                fail(f"decode_attention written cache {name} not bit-exact "
                     f"({dt})")
        if not (torch.equal(again, got)
                and all(torch.equal(a, c) for a, c in zip(rc, kc))):
            fail(f"decode_attention: a second launch gave other bits ({dt})")
    err, tol = errs[torch.float32], 1e-3
    if not err <= tol:
        fail(f"decode_attention: ctx max err {err} > {tol}")
    t = _decode_times(
        torch, lambda: decode_attention(q, *kc, nk, nv, pos),
        lambda: decode_attention_plain(q, *pc, nk, nv, pos),
        _sdpa_yardstick(torch, dev, q, *cache, pos),
        *_decode_cost(q, nk, pos, kh, hd, g))
    print(f"decode_attention B={b} S={s} K={kh} G={g} hd={hd} pos "
          f"{pos.tolist()}: ctx max err {err:.2e} (tol {tol}, fp32 "
          f"carrier, bf16-valued inputs), bf16 carrier within one bf16 "
          f"step (max err {errs[torch.bfloat16]:.2e}), written rows "
          f"bit-exact, a second launch bit-identical; {_time_line(t)}")
    _store(results, "decode_attention", tag, dict(
        route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:250", tol=tol,
        shape=f"B={b},S={s},K={kh},G={g},hd={hd}", max_abs_err=err, **t))


def paged_from_dense(torch, dense, lengths, page, seed):
    """Re-lay dense (B, S, K, x) caches as page pools and a (B, S / page)
    table (a torch copy of repro/kernels/ref.py:paged_from_dense): slot
    b's first min(maxp, ceil(len / page) + 1) logical pages go to pages in
    an order shuffled by ``seed``, one spare page pads the pool, the rest
    of the table points at the trash page 0."""
    import numpy as np
    b, s = dense[0].shape[:2]
    maxp = s // page
    need = [min(maxp, -(-int(n) // page) + 1) for n in lengths]
    total = 1 + sum(need) + 1
    order = list(np.random.RandomState(seed).permutation(np.arange(1, total)))
    table = np.zeros((b, maxp), np.int32)
    bi, ji, pid = [], [], []
    for i in range(b):
        for j in range(need[i]):
            table[i, j] = order.pop()
            bi.append(i), ji.append(j), pid.append(int(table[i, j]))
    pools = []
    for t in dense:
        pool = torch.zeros((total, page) + tuple(t.shape[2:]), dtype=t.dtype,
                           device=t.device)
        pool[pid] = t.reshape(b, maxp, page, *t.shape[2:])[bi, ji]
        pools.append(pool)
    return pools, torch.from_numpy(table).to(dense[0].device)


def check_decode_attention_paged(torch, dev, gen, results,
                                 shape=DECODE_SHAPE, tag=None):
    """Phase 3b: #13 at GPT-2 small's decode widths (16 slots, a logical
    cache of 1024 rows, 12 kv heads of 64; phase 16: ``YI_DECODE_SHAPE``)
    over shuffled pools of pages of
    16, 64 (the serving phases' page) and 256 rows, at ``_decode_pos``'s
    positions with a freed slot (pos 0, a table row of trash-page entries)
    and a full one (pos == maxp * page, the clamped write).  (a) Against
    its plain version at both carriers: ctx within 1e-3 at float32 (within
    one bf16 step at bfloat16), the written pools bit for bit outside the
    trash page, a second launch on a clone bit-identical.  (b) Against #12
    on the source dense cache: ctx and the written rows at their logical
    positions bit for bit.  Timed queued and call by call beside SDPA."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_paged,
                                                 decode_attention_paged_plain,
                                                 paged_logical_view)
    b, s, kh, g, hd = shape
    pos = _decode_pos(torch, dev, gen, b, s)
    dense = _int8_cache(torch, dev, gen, b, s, kh, hd, pos)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).bfloat16()
    nk = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    nv = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    live = torch.arange(1, b, device=dev)            # slot 0: the trash page
    at = pos.clamp(0, s - 1).long()[1:]
    rows_out = []
    for page in (16, PAGE, 256):
        pools, table = paged_from_dense(torch, dense, pos.tolist(), page,
                                        seed=page)
        table[0] = 0
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt) for t in (q, nk, nv)]
            kc = [t.clone() for t in pools]
            pc = [t.clone() for t in pools]
            rc = [t.clone() for t in pools]
            got = decode_attention_paged(args[0], *kc, *args[1:], pos, table)
            want = decode_attention_paged_plain(args[0], *pc, *args[1:], pos,
                                                table)
            again = decode_attention_paged(args[0], *rc, *args[1:], pos,
                                           table)
            errs[dt] = attention_err(torch, got, want)
            for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, pc):
                if not torch.equal(a[1:], c[1:]):
                    fail(f"decode_attention_paged page {page}: written pool "
                         f"{name} not bit-exact against the plain version "
                         f"({dt})")
            if not (torch.equal(again, got) and all(
                    torch.equal(a[1:], c[1:]) for a, c in zip(rc, kc))):
                fail(f"decode_attention_paged page {page}: a second launch "
                     f"gave other bits ({dt})")
            dc = [t.clone() for t in dense]
            kc = [t.clone() for t in pools]
            dctx = decode_attention(args[0], *dc, *args[1:], pos)
            pctx = decode_attention_paged(args[0], *kc, *args[1:], pos, table)
            torch.cuda.synchronize()
            if not torch.equal(dctx, pctx):
                fail(f"decode_attention_paged page {page} ({dt}): ctx differs "
                     f"from decode_attention on the same logical cache (max "
                     f"{(dctx.float() - pctx.float()).abs().max().item()})")
            pid = table[live, at // page].long()
            for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, dc):
                if not torch.equal(a[pid, at % page], c[live, at]):
                    fail(f"decode_attention_paged page {page} ({dt}): written "
                         f"rows of {name} differ from decode_attention's")
        err, tol = errs[torch.float32], 1e-3
        if not err <= tol:
            fail(f"decode_attention_paged page {page}: ctx max err {err} "
                 f"> {tol}")
        kc = [t.clone() for t in pools]
        pc = [t.clone() for t in pools]
        # the yardstick reads the gathered logical view (gather untimed)
        view = [paged_logical_view(t, table) for t in pools]
        t = _decode_times(
            torch, lambda: decode_attention_paged(q, *kc, nk, nv, pos, table),
            lambda: decode_attention_paged_plain(q, *pc, nk, nv, pos, table),
            _sdpa_yardstick(torch, dev, q, *view, pos),
            *_decode_cost(q, nk, pos, kh, hd, g, extra=4 * table.numel()))
        print(f"decode_attention_paged B={b} S={s} page={page} K={kh} G={g} "
              f"hd={hd} pos [0 (trash slot), {s}, chunk edges, ragged]: ctx "
              f"max err {err:.2e} (tol {tol}, fp32 carrier), bf16 carrier "
              f"within one bf16 step (max err {errs[torch.bfloat16]:.2e}), "
              f"written pools bit-exact outside page 0, a second launch "
              f"bit-identical; ctx and written rows bit-identical to "
              f"decode_attention on the dense cache (both carriers); "
              f"{_time_line(t)}")
        rows_out.append(dict(shape=f"B={b},S={s},page={page},K={kh},G={g},"
                             f"hd={hd}", max_abs_err=err, **t))
        del pools, kc, pc, rc, view
    # the JSON entry reports the serving phases' page of 64 rows
    _store(results, "decode_attention_paged", tag, dict(
        route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:374", tol=1e-3,
        shapes=rows_out, **rows_out[1]))


#: phase 3, #11: the serving gate (4 prompts of 256 over 1024-row
#: buffers) and the engine's extremes (16 slots at the 512 bucket, one
#: prompt at 32), GPT-2 small's heads
Q8_SHAPES = ((4, 256, 1024, 12, 12, 64), (16, 512, 1024, 12, 12, 64),
             (1, 32, 1024, 12, 12, 64))
#: #11's limit on max |kernel - plain| at float32: the CUDA-core kernel's
#: output, and the tensor-core kernel's output before its bf16 cast
Q8_TOL = 1e-3


def _q8_control(torch, q, kq, ks, vq, vs):
    """The plain version with p * g(vs) rounded to one bf16 term before the
    P.V product: what feeding the tensor cores one term, not three, gives."""
    from repro_torch.kernels.flash_attn import scale_guard
    b, sq, h, hd = q.shape
    skv, kh = kq.shape[1], kq.shape[2]
    g = h // kh
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kq.float())
    s = s * scale_guard(ks)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    qpos = torch.arange(sq, device=q.device)
    s = s.masked_fill(torch.arange(skv, device=q.device)[None, :]
                      > qpos[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    p = p * scale_guard(vs)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    ctx = torch.einsum("bkgqt,btkd->bqkgd", p.bfloat16().float(), vq.float())
    return ctx.reshape(b, sq, h, hd)


def check_flash_q8(torch, dev, gen, results, shapes=Q8_SHAPES, tag=None):
    """Phase 3, #11 at ``Q8_SHAPES``: the bf16 tensor-core kernel
    (``flash_q8_sm90.cu``) within one bf16 step of the plain version, its
    output before the cast within ``Q8_TOL`` of the plain version at
    float32 (rel L2 printed beside a control that rounds p * g(vs) to one
    bf16 term), a repeat bit-identical; the float32 carrier (the
    CUDA-core kernel) within ``Q8_TOL``; each timed call by call and
    queued beside the CUDA-core kernel at bf16 (the first port's), SDPA on
    dequantized K/V (queued), the plain version and the bound (bytes, or
    the bf16-exact products at 989 TFLOP/s, each fp32 operand counted as
    its terms); ``HGMMA`` in every ``flash_q8_sm90`` kernel's SASS.
    Phase 16 runs it at ``YI_Q8_SHAPE`` (``tag``), the SASS check left to
    phase 3."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    rows = []
    for b, sq, skv, h, kh, hd in shapes:
        kq, ks, vq, vs = _int8_cache(torch, dev, gen, b, skv, kh, hd,
                                     [sq] * b)
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).bfloat16()
        got = fa.flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True)
        want = fa.flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=True)
        bf16_err = attention_err(torch, got, want)
        again = fa.flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True)
        f32 = fa.launch_q8("flash_q8_sm90", q, kq, ks, vq, vs, causal=True,
                           out_dtype=torch.float32)
        want32 = fa.flash_attention_fwd_q8_plain(q.float(), kq, ks, vq, vs,
                                                 causal=True)
        core = fa.flash_attention_fwd_q8(q.float(), kq, ks, vq, vs,
                                         causal=True)
        ctl = _q8_control(torch, q, kq, ks, vq, vs)
        torch.cuda.synchronize()
        err = (f32 - want32).abs().max().item()
        core_err = (core - want32).abs().max().item()
        rel = _rel_l2(torch, [f32], [want32])
        ctl_rel = _rel_l2(torch, [ctl], [want32])
        if not torch.equal(again, got):
            fail(f"flash_attention_fwd_q8 {b}x{sq}: a repeat gave other bits")
        if err > Q8_TOL or core_err > Q8_TOL:
            fail(f"flash_attention_fwd_q8 {b}x{sq}: max err {err} (bf16 "
                 f"kernel before its cast) / {core_err} (fp32 kernel) > "
                 f"{Q8_TOL}")
        ms = queued_ms(lambda: fa.flash_attention_fwd_q8(q, kq, ks, vq, vs))
        ms_call = time_ms(lambda: fa.flash_attention_fwd_q8(q, kq, ks, vq, vs))
        core_ms = queued_ms(lambda: fa.launch_q8("flash_attn_q8", q, kq, ks,
                                                vq, vs))
        plain = time_ms(lambda: fa.flash_attention_fwd_q8_plain(
            q, kq, ks, vq, vs), iters=3)
        # the KV heads expanded to the query heads (KV-major groups)
        kd = _dequant(torch, kq, ks).bfloat16().permute(0, 2, 1, 3
                                                        ).repeat_interleave(
                                                            h // kh, 1)
        vd = _dequant(torch, vq, vs).bfloat16().permute(0, 2, 1, 3
                                                        ).repeat_interleave(
                                                            h // kh, 1)
        qt = q.permute(0, 2, 1, 3)
        lib = queued_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, is_causal=True))
        lib_call = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, is_causal=True))
        # q read and out written once, the causally visible K/V rows and
        # their scales once; per visible pair q.k (one term at hd 64, three
        # elsewhere) and p.v (three terms), 2 * hd FLOPs each
        visible = min(skv, sq)
        nbytes = 2 * q.numel() * 2 + 2 * b * visible * kh * (hd + 4)
        q_terms = 1 if hd in (64, 256) else 3
        ops = (q_terms + 3) * 2.0 * hd * b * h * (sq * (sq + 1) / 2)
        bd, by = bound_ms(nbytes, ops, BF16_FLOPS)
        rows.append(dict(shape=f"B={b},Sq={sq},Skv={skv},H={h},K={kh},"
                               f"hd={hd}",
                         max_abs_err=err, bf16_max_abs_err=bf16_err,
                         rel_l2=rel, control_rel_l2=ctl_rel,
                         fp32_max_abs_err=core_err, ms=ms, ms_call=ms_call,
                         cuda_core_ms=core_ms, plain_ms=plain, bound_ms=bd,
                         bound_by=by, library_ms=lib, library_ms_call=lib_call))
        print(f"flash_attention_fwd_q8 B={b} Sq={sq} Skv={skv} H={h} K={kh} "
              f"hd={hd} "
              f"causal, bf16 (flash_q8_sm90): within one bf16 step (max err "
              f"{bf16_err:.2e}), repeat bit-identical, before the cast max "
              f"err {err:.2e} (tol {Q8_TOL}) rel L2 {rel:.2e} (control, "
              f"p*g(vs) as one bf16 term: {ctl_rel:.2e}); fp32 carrier "
              f"(flash_attn_q8) max err {core_err:.2e}; queued ms {ms:.4f} "
              f"(call by call {ms_call:.4f}), the CUDA-core kernel at bf16 queued "
              f"{core_ms:.4f}, plain_ms {plain:.4f}, bound_ms {bd:.5f} ({by}),"
              f" library_ms(SDPA, queued) {lib:.4f} (call by call "
              f"{lib_call:.4f})")
        del kq, ks, vq, vs, q, got, want, again, f32, want32, core, ctl, kd, vd
    if tag:
        results["flash_attention_fwd_q8"][tag] = rows[0]
        return
    counts = sass_counts("flash_q8_sm90", "HGMMA")
    print(f"flash_q8_sm90 SASS: {sum(counts.values())} HGMMA instructions "
          f"over {len(counts)} kernels (each "
          f"{min(counts.values(), default=0)}-"
          f"{max(counts.values(), default=0)})")
    if not counts or min(counts.values()) == 0:
        fail(f"phase 3: a flash_q8_sm90 kernel has no HGMMA: {counts}")
    results["flash_attention_fwd_q8"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_q8_sm90.cu",
        replaces="src/repro/kernels/flash_attn.py:468", tol=Q8_TOL,
        shapes=rows, **rows[0])


def serve_model(torch, dev, seed):
    """GPT-2 small at full width and depth, random weights from ``seed``:
    (cfg, model, params) of phases 4, 4b and 4c."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gpt2-small")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    return cfg, model, params


def ladder_prompts(cfg, seed):
    """The 32 prompts of phases 17a and 17c: lengths in
    ``LADDER_PROMPT_LENS`` (one prefill bucket), drawn from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed + 5)
    lo, hi = LADDER_PROMPT_LENS
    lens = rng.randint(lo, hi + 1, size=SERVE_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def serve_prompts(cfg, seed):
    """The 32 prompts of phases 4 and 4b (32-512 tokens), drawn from
    ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(32, 513, size=SERVE_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def serve(torch, dev, seed):
    """Phase 4: the dense engine on GPT-2 small; returns the launch counts,
    each request's tokens and the engine's KV bytes."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.infer import Engine, Request
    cfg, model, params = serve_model(torch, dev, seed)
    eng = Engine(model, params, POLICY, max_slots=SERVE_SLOTS,
                 max_seq=SERVE_SEQ, device=dev, seed=seed)
    prompts = serve_prompts(cfg, seed)
    lens = np.asarray([len(p) for p in prompts])
    new = SERVE_NEW
    ids = [eng.submit(Request(tokens=p, max_new_tokens=new))
           for p in prompts]
    rng = np.random.RandomState(seed + 3)
    print(f"engine: {eng.path_summary()}, {cfg.name} {cfg.n_layers}L "
          f"d={cfg.d_model} carrier {cfg.dtype}, 16 slots x 1024 rows, "
          f"{len(ids)} requests, prompts {lens.min()}-{lens.max()} tokens, "
          f"{new} new tokens each")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats
    if sorted(r.request_id for r in out) != sorted(ids):
        fail("engine did not answer every request")
    for r in out:
        if (len(r.tokens) != new or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    lat = eng.scheduler.latency_stats()
    gen_tok = sum(len(r.tokens) for r in out)
    print(f"engine: {len(out)} requests served, {gen_tok} tokens in "
          f"{wall:.3f} s ({gen_tok / wall:.1f} tok/s end to end); prefill "
          f"{st['prefill_calls']} launches {st['prefill_s'] * 1e3:.1f} ms "
          f"({st['prefill_tokens']} prompt tokens); decode "
          f"{st['decode_steps']} steps {st['decode_s'] * 1e3:.1f} ms "
          f"({st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} "
          f"ms/step, {st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} "
          f"tok/s); latency p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s")
    print(f"engine: launch counts {counts}")
    linears = 6 * cfg.n_layers
    want = {"int8_matmul": linears * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd_q8": cfg.n_layers * st["prefill_calls"],
            "decode_attention": cfg.n_layers * st["decode_steps"]}
    for name, n in want.items():
        if counts[name] <= 0 or counts[name] != n:
            fail(f"{name} launched {counts[name]} times on the main path, "
                 f"expected {n}")
    if counts["decode_attention_paged"]:
        fail("the dense engine launched decode_attention_paged")
    healthy(eng, "phase 4")
    tokens = {r.request_id: r.tokens for r in out}
    dense_bytes, stats = eng.kv_cache_nbytes(), dict(st)
    profile_decode(torch, eng, cfg, rng)
    eng.scheduler.stop()          # ends the emit thread, which holds eng
    return counts, [tokens[i] for i in ids], dense_bytes, stats


def decode_step_bytes(eng, cfg):
    """The bytes one decode step must move at the engine's positions, the
    least it could read and write: every parameter once (the head too; the
    hybrid's shared block once an invocation), each running slot's live KV
    rows of every cache read once and its new row written, and the SSM
    states read and written.  Returns (total, {part: bytes})."""
    from repro_torch.infer.prepare import params_nbytes
    parts = {"params": params_nbytes(eng.params)}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid_attn_every
        parts["params"] += (groups - 1) * params_nbytes(eng.params["shared"])
    caches = eng._state.get("caches")
    if caches is not None and not eng.paged:
        n, s, kh = (caches["k"].shape[0], caches["k"].shape[2],
                    caches["k"].shape[3])
        row = sum(t[0, 0, 0].numel() * t.element_size()
                  for t in caches.values())          # every buffer, 1 row
        live = sum(min(int(eng._pos[i]), s) + 1 for i in eng._running)
        parts["kv"] = n * live * row
    if eng._state.get("ssm") is not None:
        parts["ssm"] = 2 * sum(t.numel() * t.element_size()
                               for t in eng._state["ssm"].values())
    return sum(parts.values()), parts


def profile_decode(torch, eng, cfg, rng) -> None:
    """Where a decode step's time goes: torch.profiler over 4 steps with
    every slot live (16 fresh 64-token requests, admitted outside the
    window, stepped on this thread); device time by kernel and the device's
    idle share of the steps' wall time.  Runs after the main path's launch
    counts are read (phases 4 and 4b)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.infer import Request
    for _ in range(eng.max_slots):
        eng.submit(Request(tokens=rng.randint(0, cfg.vocab_size, 64).tolist(),
                           max_new_tokens=8))
    eng.scheduler.step()                     # prefill + one decode step
    torch.cuda.synchronize()
    step_bytes, parts = decode_step_bytes(eng, cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.scheduler.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(k[1] for k in kern)
    if not busy:
        print("profile: no device time recorded (not measured)")
        return
    kern.sort(key=lambda k: -k[1])
    print(f"profile: {'paged' if eng.paged else 'dense'} engine, 4 decode "
          f"steps x 16 slots, wall {wall_us / 4e3:.2f} ms/step, "
          f"device busy {busy / 4e3:.2f} ms/step, idle share "
          f"{1 - busy / wall_us:.3f}, {sum(k[2] for k in kern) / 4:.0f} "
          f"kernel launches/step; the byte bound of a step at the window's "
          f"first positions {step_bytes / HBM_BPS * 1e3:.3f} ms ("
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
          + ")")
    for name, us, n in kern[:8]:
        print(f"profile:   {us / 4e3:8.3f} ms/step {n // 4:5d} launches/step "
              f"{name[:90]}")
    attn = [k for k in kern if "decode_chunk_kernel" in k[0]
            or "decode_combine_kernel" in k[0]]
    if cfg.family != "ssm":
        print(f"profile: decode attention (decode_attn.cu's two kernels) "
              f"{sum(k[1] for k in attn) / 4e3:.3f} ms/step in "
              f"{sum(k[2] for k in attn) // 4} kernels/step")
    fwd = [k for k in kern if int8_kernel_side(k[0]) == "fwd"]
    print(f"profile: the int8 forward (int8_matmul, FWD_STAGES) "
          f"{sum(k[1] for k in fwd) / 4e3:.3f} ms/step in "
          f"{sum(k[2] for k in fwd) // 4} kernels/step")
    # the host's side: self CPU time of the traced torch ops (the profiler's
    # own cost included; Python between the ops is not traced)
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total), key=lambda h: -h[1])
    print(f"profile: host, self CPU time of the traced ops "
          f"{sum(h[1] for h in host) / 4e3:.2f} ms/step; the largest: "
          + ", ".join(f"{name} {us / 4e3:.3f} ms ({n // 4}/step)"
                      for name, us, n in host[:8]))


def serve_paged(torch, dev, seed, dense_tokens, dense_bytes, dense_stats):
    """Phase 4b: the paged engine (pages of 64 rows, the default pool of
    1 + 16 x 16 pages) under the async scheduler, on the weights and the
    32 requests of phase 4, submitted from this thread with exponential
    gaps (mean 20 ms) while the background loop serves.  Every request
    must be answered to length with phase 4's tokens; the counts must show
    the paged path (12 ``decode_attention_paged`` a decode step, no
    ``decode_attention``); the peak live KV must stay below the dense
    cache; every page must be back after ``stop()``.  Returns the counts."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.infer import Engine, Request
    cfg, model, params = serve_model(torch, dev, seed)
    eng = Engine(model, params, POLICY, max_slots=SERVE_SLOTS,
                 max_seq=SERVE_SEQ, device=dev, seed=seed, paged=True,
                 page_size=PAGE)
    prompts = serve_prompts(cfg, seed)
    gaps = np.random.RandomState(seed + 1).exponential(ARRIVAL_MEAN_S,
                                                       size=len(prompts))
    groups = []                  # request ids of each prefill launch
    admit = eng._admit_paged

    def logged(selected, shares):
        groups.append([r.request_id for r in selected])
        return admit(selected, shares)
    eng._admit_paged = logged
    sched = eng.scheduler
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sched.start()
    try:
        ids = []
        for p, gap in zip(prompts, gaps):
            ids.append(eng.submit(Request(tokens=p, max_new_tokens=SERVE_NEW)))
            time.sleep(float(gap))
        sched.wait(ids, timeout=600)
    finally:
        sched.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    out = [sched.result(i) for i in ids]
    st = eng.stats
    print(f"engine paged: {eng.path_summary()}, {cfg.name} {cfg.n_layers}L "
          f"d={cfg.d_model}, {SERVE_SLOTS} slots x {SERVE_SEQ} rows, "
          f"{eng.n_pages} pages of {PAGE} rows, {len(ids)} requests "
          f"(phase 4's), exponential arrival gaps of mean "
          f"{ARRIVAL_MEAN_S * 1e3:.0f} ms (submitting took "
          f"{float(gaps.sum()):.3f} s), async scheduler")
    for r in out:
        if (len(r.tokens) != SERVE_NEW or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"paged request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    for i, (r, want) in enumerate(zip(out, dense_tokens)):
        if r.tokens != want:
            at = next(j for j, (a, c) in enumerate(zip(r.tokens, want))
                      if a != c)
            fail(f"paged request {i} differs from the dense engine's at "
                 f"token {at} ({r.tokens[at]} vs {want[at]}); prompt of "
                 f"{len(prompts[i])} tokens; prefill groups {groups}")
    lat = sched.latency_stats()
    gen_tok = sum(len(r.tokens) for r in out)
    dec_ms = st["decode_s"] * 1e3 / max(st["decode_steps"], 1)
    dense_ms = dense_stats["decode_s"] * 1e3 / max(
        dense_stats["decode_steps"], 1)
    print(f"engine paged: {len(out)} requests served, tokens equal to phase "
          f"4's for all {len(out)}; {gen_tok} tokens in {wall:.3f} s "
          f"({gen_tok / wall:.1f} tok/s end to end, arrivals included); "
          f"prefill {st['prefill_calls']} launches {st['prefill_s'] * 1e3:.1f}"
          f" ms ({st['prefill_tokens']} prompt tokens, groups of "
          f"{[len(g) for g in groups]}); decode {st['decode_steps']} steps "
          f"{st['decode_s'] * 1e3:.1f} ms ({dec_ms:.2f} ms/step against the "
          f"dense engine's {dense_ms:.2f} in phase 4, "
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tok/s); "
          f"latency p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s mean "
          f"{lat['mean_s']:.3f} s; peak live KV {sched.peak_live_bytes} B = "
          f"{sched.peak_live_bytes / dense_bytes:.3f} of the dense cache's "
          f"{dense_bytes} B; peak queue depth {lat['peak_queue_depth']}; "
          f"preemptions {eng.preemptions}")
    print(f"engine paged: launch counts {counts}")
    linears = 6 * cfg.n_layers
    want = {"int8_matmul": linears * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd_q8": cfg.n_layers * st["prefill_calls"],
            "decode_attention_paged": cfg.n_layers * st["decode_steps"],
            "decode_attention": 0}
    for name, n in want.items():
        if counts[name] != n or (n == 0 and name != "decode_attention"):
            fail(f"paged path: {name} launched {counts[name]} times, "
                 f"expected {n} (> 0 for a kernel of the path)")
    if not sched.peak_live_bytes < dense_bytes:
        fail(f"paged peak live KV {sched.peak_live_bytes} B not below the "
             f"dense cache's {dense_bytes} B")
    if eng.pool.free_pages != eng.n_pages - 1 or eng.pool.live_pages:
        fail(f"paged engine kept pages after stop(): {eng.pool.free_pages} "
             f"free of {eng.n_pages - 1}")
    healthy(eng, "phase 4b")
    profile_decode(torch, eng, cfg, np.random.RandomState(seed + 3))
    sched.stop()
    return counts


def serve_paged_pressure(torch, dev, seed):
    """Phase 4c, at full width and depth on the card, after the main
    path's counts are read.  (i) A pool of 1 + 24 pages of 64 rows and 16
    requests of 300- and 500-token prompts: every request must finish with 64
    tokens ("length") through at least one preemption, and every page must
    come back.  (ii) ``cache_prefix`` of a 256-token prefix, then 8
    requests of that prefix plus 16-64 random tokens: the tokens must equal
    the same requests' on a fresh paged engine without the cached prefix,
    the admitted requests must share the prefix pages, and afterwards the
    prefix pages' refcounts must be back at their pin (alloc + pin)."""
    import numpy as np
    from repro_torch.infer import Engine, Request
    cfg, model, params = serve_model(torch, dev, seed)
    kw = dict(max_slots=SERVE_SLOTS, max_seq=SERVE_SEQ, device=dev, seed=seed,
              paged=True, page_size=PAGE)
    rng = np.random.RandomState(seed + 2)
    eng = Engine(model, params, POLICY, n_pages=25, **kw)
    # preemption follows from the lengths alone (no eos): alternating 300
    # and 500 tokens preempts, where a random draw of 300-500 may fit the
    # admission headroom (seed 0's does) and test nothing
    lens = np.asarray([300, 500] * 8)
    ids = [eng.submit(Request(tokens=rng.randint(0, cfg.vocab_size, n)
                              .tolist(), max_new_tokens=SERVE_NEW))
           for n in lens]
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.scheduler.stop()
    bad = [(r.request_id, len(r.tokens), r.finish_reason) for r in out
           if len(r.tokens) != SERVE_NEW or r.finish_reason != "length"]
    st = eng.stats
    print(f"engine paged pressure (i): 16 requests, prompts {lens.min()}-"
          f"{lens.max()} tokens, {SERVE_NEW} new, a pool of 24 pages of "
          f"{PAGE} rows: {len(out)} served in {wall:.3f} s, preemptions "
          f"{eng.preemptions}, prefill {st['prefill_calls']} launches, "
          f"decode {st['decode_steps']} steps, peak live KV "
          f"{eng.scheduler.peak_live_bytes} B, pages free after "
          f"{eng.pool.free_pages}/24")
    if sorted(r.request_id for r in out) != sorted(ids) or bad:
        fail(f"paged pressure: requests not served to length: {bad}")
    if eng.preemptions < 1:
        fail("paged pressure: no preemption under a 24-page pool")
    if eng.pool.free_pages != 24:
        fail(f"paged pressure: {24 - eng.pool.free_pages} pages not returned")
    healthy(eng, "phase 4c (i)")

    prefix = rng.randint(0, cfg.vocab_size, 256).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size,
                                    rng.randint(16, 65)).tolist()
               for _ in range(8)]
    runs, engines = [], []
    for cached in (True, False):
        eng = Engine(model, params, POLICY, **kw)
        if cached:
            n_pg = eng.cache_prefix(prefix)
            pids = eng._prefixes[tuple(prefix)]
        ids = [eng.submit(Request(tokens=p, max_new_tokens=SERVE_NEW))
               for p in prompts]
        if cached:
            eng.scheduler.step()                 # admission + one step
            shared = int(eng.pool.refcount[pids].min())
        by_id = {r.request_id: r.tokens for r in eng.run()}
        eng.scheduler.stop()
        healthy(eng, "phase 4c (ii)")
        runs.append([by_id[i] for i in ids])
        engines.append(eng)
    torch.cuda.synchronize()
    refs = [int(engines[0].pool.refcount[p]) for p in pids]
    print(f"engine paged prefix (ii): a {len(prefix)}-token prefix cached "
          f"as {n_pg} pages, 8 requests of prefix + 16-64 tokens: each "
          f"prefix page held by at least {shared - 2} admitted requests "
          f"after the first step, refcounts after the run {refs} (alloc + "
          f"pin = 2); tokens {'equal' if runs[0] == runs[1] else 'DIFFER'} "
          f"to a fresh engine's without the cached prefix")
    if runs[0] != runs[1]:
        fail("paged prefix sharing changed the tokens")
    if shared < 3:
        fail(f"paged prefix pages not shared (refcount {shared})")
    if refs != [2] * n_pg or engines[0].pool.live_pages != n_pg:
        fail(f"prefix pages' refcounts {refs} after the run, expected 2 "
             f"each (live pages {engines[0].pool.live_pages})")


def _teacher_forced(torch, model, cfg, params, toks, policy, device,
                    kv_path=None):
    """Logits of a 64-token prefill and 8 teacher-forced decode steps,
    (9, B, vocab), on ``device``; the KV caches as the last step left them
    (the SSM family: its SSM and conv states).  ``kv_path`` picks how an
    int8 cache is read (phase 17b)."""
    from repro_torch.infer.prepare import prepare_params
    from repro_torch.models.common import tree_map
    p = prepare_params(cfg, tree_map(lambda t: t.to(device), params), policy)
    lg, st = model.prefill(p, toks[:, :64].to(device), policy=policy,
                           max_seq=80, kv_path=kv_path)
    out = [lg.cpu()]
    for i in range(8):
        pos = torch.full((toks.shape[0],), 64 + i, dtype=torch.int32,
                         device=device)
        lg, st = model.decode(p, st, toks[:, 64 + i:65 + i].to(device), pos,
                              policy=policy, kv_path=kv_path)
        out.append(lg.cpu())
    return (torch.stack(out)[..., :cfg.vocab_size],
            st["ssm"] if st["caches"] is None else st["caches"])


@contextlib.contextmanager
def plain_versions(names):
    """Inside, the model calls the named kernels' plain versions in their
    place, on whatever device its tensors are: the card-against-card
    comparisons of phases 5, 8, 12 and 15.  ``int8_matmul`` swaps both of
    its entries on the ``ops`` module: the int8 one and the fused decode
    entry ``int8_quant_matmul``, and ``int8_matmul_experts`` both of its
    expert-batched instance's.  Nothing in the port does this."""
    import repro_torch.kernels.flash_attn as flash_attn
    import repro_torch.kernels.ops as ops
    import repro_torch.kernels.opt_update as opt_update
    import repro_torch.models.attention as attention
    from repro_torch.kernels.decode_attn import decode_attention_plain
    from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_experts_plain, int8_matmul_nt_experts_plain,
        int8_matmul_nt_plain, int8_matmul_plain,
        int8_matmul_tn_experts_plain, int8_matmul_tn_plain,
        int8_quant_matmul_experts_plain, int8_quant_matmul_plain)
    from repro_torch.kernels.qdq import qdq_row_plain, qdq_scaled_plain
    sites = {"int8_matmul": [(ops, "int8_matmul", int8_matmul_plain),
                             (ops, "int8_quant_matmul",
                              int8_quant_matmul_plain)],
             "int8_matmul_experts": [
                 (ops, "int8_matmul_experts", int8_matmul_experts_plain),
                 (ops, "int8_quant_matmul_experts",
                  int8_quant_matmul_experts_plain)],
             "qdq_row": [(ops, "qdq_row", qdq_row_plain)],
             "qdq_scaled": [(ops, "qdq_scaled", qdq_scaled_plain)],
             "flash_attention_fwd_q8": [(attention, "flash_attention_fwd_q8",
                                         flash_attention_fwd_q8_plain)],
             "decode_attention": [(attention, "decode_attention",
                                   decode_attention_plain)],
             "int8_matmul_nt": [(ops, "int8_matmul_nt", int8_matmul_nt_plain)],
             "int8_matmul_tn": [(ops, "int8_matmul_tn", int8_matmul_tn_plain)],
             "int8_matmul_nt_experts": [(ops, "int8_matmul_nt_experts",
                                         int8_matmul_nt_experts_plain)],
             "int8_matmul_tn_experts": [(ops, "int8_matmul_tn_experts",
                                         int8_matmul_tn_experts_plain)],
             "fused_adamw_blocks": [(opt_update, "fused_adamw_blocks",
                                     opt_update.fused_adamw_blocks_plain)],
             "fused_adamw_leaves": [(opt_update, "fused_adamw_leaves",
                                     opt_update.fused_adamw_leaves_plain)],
             # the model's attention calls #7 through its own binding
             **{n: [(mod, n, getattr(flash_attn, n + "_plain"))
                    for mod in (flash_attn, attention) if hasattr(mod, n)]
                for n in FLASH_KERNELS}}
    swaps = [site for n in names for site in sites[n]]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    try:
        for mod, attr, plain in swaps:
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _agreement(torch, card, cpu, margin):
    err = (card - cpu).abs().max().item()
    top2 = cpu.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > margin
    agree = card.argmax(-1) == cpu.argmax(-1)
    return err, int(agree.sum()), int((decided & ~agree).sum())


#: the SSM layer's leaves of the reference's ``fan_in`` init: the five
#: projections and the conv (its true fan-in the conv's width)
SSM_FAN_IN = ("in_z", "in_x", "in_bc", "in_dt", "out_proj", "conv_w")


def true_fan_in(params, cfg):
    """The block weights rescaled from the reference init's std 1/sqrt(L)
    (its fan-in is read from the stacked layer dim; ROADMAP section 3) to
    the true fan-in's 1/sqrt(d_in) (an SSM layer's conv: 1/sqrt(width)).
    At the reference's scale the random model's logits jump by up to about
    1 with the last bit of its inputs, so the plain versions alone put the
    card that far from the CPU (PERF.md); at this scale they stay
    continuous enough to compare.  The encoder-decoder's two stacks are
    each rescaled from their own depth."""
    stacks = ({"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
              if cfg.family == "encdec" else {"blocks": cfg.n_layers})
    out = dict(params)
    for key, depth in stacks.items():
        out[key] = {mod: {n: (w * math.sqrt(depth / w.shape[-2])
                              if n.startswith("w") or n in SSM_FAN_IN else w)
                          for n, w in leaves.items()}
                    for mod, leaves in params[key].items()}
    return out


@contextlib.contextmanager
def routes_recorded(log):
    """Inside, every MoE router call appends its (T, k) top experts, on the
    CPU, to ``log`` (the calls come in the same order on any device)."""
    import repro_torch.models.moe as moe
    route = moe._route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        log.append(out[1].cpu())
        return out
    moe._route = recorded
    try:
        yield
    finally:
        moe._route = route


@contextlib.contextmanager
def routes_replayed(log):
    """Inside, every MoE router call takes its top experts from ``log``
    (a ``routes_recorded`` log of another run, in call order) in place of
    its own, and its gates from its own logits at those experts
    (``moe._route``'s ``top_e``; the load-balance loss counts them too):
    two devices then dispatch every token alike, whatever near-tied logits
    would have flipped."""
    import repro_torch.models.moe as moe
    route = moe._route
    it = iter(log)

    def replayed(x2, w_router, cfg, policy, ctx):
        return route(x2, w_router, cfg, policy, ctx,
                     top_e=next(it).to(x2.device))
    moe._route = replayed
    try:
        yield
    finally:
        moe._route = route


def route_flips(torch, a, b) -> float:
    """The share of (token, k) routing choices that differ between two
    runs' ``routes_recorded`` logs."""
    n = sum(x.numel() for x in a)
    return sum(int((x != y).sum()) for x, y in zip(a, b)) / max(n, 1)


# ---------------------------------------------------------------------------
# the CPU halves of the card-vs-CPU checks, computed ahead by a worker
# ---------------------------------------------------------------------------

#: the worker of ``main()`` (None: every CPU half is computed in place)
_HALVES = None


def cpu_half(name: str, *args):
    """The CPU side of a card-vs-CPU check: ``name`` a function of this
    module called as ``fn(torch, *args)``, which draws the check's inputs
    on the CPU and computes the CPU's results, returning a dict with its
    ``draw_s`` and ``cpu_s``.  Taken from the worker (:class:`CpuHalves`)
    where ``main()`` queued it, else computed here; ``where`` and
    ``wait_s`` (the seconds this process spent on it) are added."""
    import torch
    if _HALVES is not None:
        got = _HALVES.take(name, args)
        if got is not None:
            return got
    t0 = time.perf_counter()
    out = globals()[name](torch, *args)
    out.update(where="here", wait_s=time.perf_counter() - t0)
    return out


class _inline_half:
    """The split of a check whose CPU side runs here between its card runs
    (Granite's, which replay the card's routes): the weights drawn since
    ``t_start`` and the seconds spent inside ``cpu()``, as ``cpu_half``
    reports them (``half``)."""

    def __init__(self, t_start: float):
        draw = time.perf_counter() - t_start
        self.half = dict(draw_s=draw, cpu_s=0.0, where="here", wait_s=draw)

    @contextlib.contextmanager
    def cpu(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.half["cpu_s"] += dt
            self.half["wait_s"] += dt


def print_split(what: str, half, total_s: float) -> None:
    """A check's seconds: its weights drawn and its CPU side (where they
    ran), what this process spent waiting for or computing them, and the
    rest, its card side."""
    print(f"{what}: split -- weights drawn {half['draw_s']:.1f} s, cpu side "
          f"{half['cpu_s']:.1f} s ({'in the worker' if half['where'] == 'worker' else 'here'}"
          f"; this process spent {half['wait_s']:.1f} s on them), card "
          f"side {total_s - half['wait_s']:.1f} s", flush=True)


def cpu_worker(jobs, threads: int, out_dir: str, lead) -> None:
    """The worker process of :class:`CpuHalves`: each job ``(name, args)``
    in order, at most ``lead`` results ahead of the main process, its
    result saved as ``<i>.pt`` (written to ``<i>.tmp`` and renamed) or its
    traceback as ``<i>.err``.  Its torch thread count is the main
    process's, so every CPU result has the bits it would have there; it
    runs at a lower priority than the main process, whose host-bound
    phases share the cores."""
    sys.path.insert(0, str(REPO / "src"))
    import torch
    torch.set_num_threads(threads)
    os.nice(10)
    print(f"chip_smoke: cpu worker pid {os.getpid()}, torch threads "
          f"{torch.get_num_threads()} (the main process's {threads}), "
          f"{len(jobs)} jobs", flush=True)
    for i, (name, args) in enumerate(jobs):
        lead.acquire()
        t0 = time.perf_counter()
        base = Path(out_dir) / str(i)
        try:
            out = globals()[name](torch, *args)
            t1 = time.perf_counter()
            torch.save(out, base.with_suffix(".tmp"))
            os.replace(base.with_suffix(".tmp"), base.with_suffix(".pt"))
        except BaseException:
            base.with_suffix(".err").write_text(traceback.format_exc())
            raise
        print(f"chip_smoke: cpu worker job {i} {name} "
              f"{_job_label(args)}: drew in {out['draw_s']:.1f} s, cpu "
              f"side {out['cpu_s']:.1f} s, saved in "
              f"{time.perf_counter() - t1:.1f} s, done at "
              f"{time.perf_counter() - t0:.1f} s after it started",
              flush=True)
        del out


def _job_label(args) -> str:
    return " ".join(f"{a.name} {a.n_layers}L" if hasattr(a, "n_layers")
                    else str(a) for a in args)


class CpuHalves:
    """Computes the CPU halves of the card-vs-CPU checks (``jobs``:
    ``(name, args)`` of :func:`cpu_half`, in the order the phases take
    them) in a worker process started after the build, while the card runs
    the phases before them; the checks take the saved results (``take``:
    read by ``torch.load(mmap=True)``, the file removed once mapped).  The
    sizes, seeds, limits and bits are the in-place ones: the worker draws
    the same inputs from the same seeds with the main process's thread
    count.  At most ``LEAD`` results wait on disk, under
    ``build/chip_smoke_cpu``."""

    LEAD = 2

    def __init__(self, jobs, threads: int):
        ctx = multiprocessing.get_context("spawn")
        self.jobs = list(jobs)
        self.dir = REPO / "build" / "chip_smoke_cpu"
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        self.lead = ctx.Semaphore(self.LEAD)
        self.proc = ctx.Process(target=cpu_worker,
                                args=(self.jobs, threads, str(self.dir),
                                      self.lead), daemon=True)
        self.proc.start()
        self.taken = set()

    def take(self, name: str, args):
        """The saved result of job ``(name, args)``, waiting for it; None
        if it was not queued."""
        import torch
        try:
            i = self.jobs.index((name, args))
        except ValueError:
            return None
        path = self.dir / f"{i}.pt"
        t0 = time.perf_counter()
        while not path.exists():
            if not self.proc.is_alive():
                err = self.dir / f"{i}.err"
                fail(f"the cpu worker stopped (exit code "
                     f"{self.proc.exitcode}) before job {i} {name}: "
                     + (err.read_text() if err.exists() else "no traceback"))
            time.sleep(0.02)
        out = torch.load(path, mmap=True, weights_only=False)
        path.unlink()
        self.lead.release()
        self.taken.add(i)
        out.update(where="worker", wait_s=time.perf_counter() - t0)
        return out

    def close(self):
        """Wait for the worker to end (it ends after its last job; it is
        stopped if a job was never taken) and remove its directory.
        Returns the jobs never taken."""
        missing = [j for i, j in enumerate(self.jobs) if i not in self.taken]
        if missing:
            self.proc.terminate()
        self.proc.join(timeout=60)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)
        return missing


def card_vs_cpu(torch, dev, seed, cfg=None, b_limit=B_LIMIT, control=False,
                strict=True):
    """Phase 5: teacher-forced logits of the card against the CPU, float32
    carrier, the weights of ``init_params`` (seed + 1) at the true fan-in
    scale (``true_fan_in``), 2 prompts of 64 tokens + 8 decode steps, on
    GPT-2 small (phase 16d: ``cfg``, Yi-6B's width at 2 layers, and B
    held to ``b_limit``, ``YI_B_LIMIT`` there).  Each
    policy is also run on the card with the three kernels' plain versions
    in their place, which shows how far PyTorch's own CPU and CUDA ops take
    the two devices apart.

    A. int8 weights and the int8 KV cache through both attention kernels
       (``kv_cache=a8t,*=w8c``): max |d logit| <= 1e-2, top-1 equal wherever
       the CPU's top-2 margin exceeds 1e-2.
    B. the slice's policy, which also quantizes every block linear's input
       per token, so the logits jump wherever a last-bit difference between
       the devices moves an activation across a rounding boundary.  Card
       against CPU: max |d logit| <= ``B_LIMIT``, a fixed limit set from
       recorded readings (PERF.md), top-1 equal wherever the margin exceeds
       it.  Card against card: with the plain ``int8_matmul`` in the
       kernel's place (both entries, the decode linears' fused one too)
       every logit must be bit-identical -- every one of the forward's int8
       matmuls equals its plain version.

    ``control`` (phases 19d, 20b and 21d) also runs each policy on the card
    at the bf16 carrier: its max |d logit| against the CPU's float32
    logits must exceed the policy's limit, which shows the limit tells a
    carrier apart.

    With experts (phase 21d) a last-bit difference of two near-tied router
    logits sends a token to another expert, which moves the logits by as
    much as the carrier does (PERF.md).  So the CPU, the plain
    versions and the control replay the card's own routes
    (``routes_replayed``) for the checks above, and the free-routing run's
    distance and its share of (token, k) choices that differ are reported
    beside them, ungated.  Returns each policy's readings; ``strict=False``
    prints them and fails nothing (``tools/dense_readings.py``,
    ``tools/moe_readings.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = cfg or dataclasses.replace(get_config("gpt2-small"),
                                     dtype="float32")
    model = build_model(cfg)
    t_start = time.perf_counter()
    if cfg.n_experts:
        # the CPU replays the card's routes: its side waits for the card
        params, toks = card_vs_cpu_inputs(torch, cfg, seed)
        half, moe = None, _inline_half(t_start)
    else:
        half = cpu_half("card_vs_cpu_half", cfg, seed)
        params, toks = half["params"], half["toks"]

    def run(policy, device, carrier=None, record=None, replay=None):
        c = dataclasses.replace(cfg, dtype=carrier) if carrier else cfg
        m = build_model(c) if carrier else model
        with (routes_recorded(record) if record is not None
              else routes_replayed(replay) if replay is not None
              else contextlib.nullcontext()):
            return _teacher_forced(torch, m, c, params, toks, policy, device)
    ok = True
    readings = {}
    for label, policy, limit in (("A", "kv_cache=a8t,*=w8c", 1e-2),
                                 ("B", POLICY, b_limit)):
        card_routes = [] if cfg.n_experts else None
        card, card_kv = run(policy, dev, record=card_routes)
        if half is not None:
            cpu, cpu_kv = half["cpu"][label]
        else:
            with moe.cpu():
                cpu, cpu_kv = run(policy, "cpu", replay=card_routes)
        with plain_versions(SERVE_KERNELS):
            card_plain, _ = run(policy, dev, replay=card_routes)
        err, n_agree, n_bad = _agreement(torch, card, cpu, limit)
        spread = (card_plain - cpu).abs().max().item()
        readings[label] = dict(err=err, plain=spread, disagree=n_bad)
        if cfg.n_experts:
            cpu_routes = []
            with moe.cpu():
                free, _ = run(policy, "cpu", record=cpu_routes)
            readings[label].update(
                route_flips=route_flips(torch, card_routes, cpu_routes),
                free_err=(card - free).abs().max().item())
            print(f"card vs cpu {label} {cfg.name}, each routing on its own "
                  f"(not gated): share of (token, k) routing choices that "
                  f"differ over {len(cpu_routes)} router calls "
                  f"{readings[label]['route_flips']:.3e}, max |dlogit| "
                  f"{readings[label]['free_err']:.3e}; below, the cpu, the "
                  f"plain versions and the control on the card's routes")
        if cfg.family == "ssm":
            # no KV cache: each layer's SSM state, relative L2
            flips = [_rel_l2(torch, [card_kv["ssm"][i].cpu()],
                             [cpu_kv["ssm"][i]]) for i in range(cfg.n_layers)]
        else:
            # one cache a layer, or a shared-block invocation (hybrid)
            flips = [float((card_kv["k"][i].cpu() != cpu_kv["k"][i]).float()
                           .mean()) for i in range(cpu_kv["k"].shape[0])]
        print(f"card vs cpu {label} {cfg.name} {cfg.n_layers}L d="
              f"{cfg.d_model} {policy} (float32 carrier, 2 x 64 prompt "
              f"+ 8 teacher-forced steps): max |dlogit| {err:.3e} (limit "
              f"{limit:.1e}), top-1 agree {n_agree}/{cpu.shape[0] * cpu.shape[1]}"
              f" ({n_bad} disagreements where the CPU's top-2 margin > "
              f"limit); plain versions on the card vs cpu: max |dlogit| "
              f"{spread:.3e}; "
              + ("SSM state rel L2, by layer" if cfg.family == "ssm" else
                 "share of K-cache payloads that differ, by layer")
              + f": {' '.join(f'{x:.1e}' for x in flips)}")
        ok &= err <= limit and n_bad == 0 and bool(torch.isfinite(card).all())
        if control:
            ctl, _ = run(policy, dev, carrier="bfloat16", replay=card_routes)
            ctl_err = (ctl - cpu).abs().max().item()
            readings[label]["control"] = ctl_err
            print(f"card vs cpu {label} {cfg.name} control: the card at the "
                  f"bf16 carrier vs the cpu at float32: max |dlogit| "
                  f"{ctl_err:.3e} (must exceed the limit {limit:.1e})")
            ok &= ctl_err > limit
        if policy == POLICY:
            with plain_versions(["int8_matmul", "int8_matmul_experts"]):
                card_mm_plain, _ = run(policy, dev)
            same = torch.equal(card_mm_plain, card)
            print(f"card vs card {label} {cfg.name}: plain int8_matmul "
                  f"(and int8_matmul_experts) in the kernels' "
                  f"place: logits {'bit-identical' if same else 'DIFFER'} "
                  f"(tol 0; max |dlogit| "
                  f"{(card_mm_plain - card).abs().max().item():.3e})")
            readings[label]["mm_plain_same"] = same
            ok &= same
    print_split(f"card vs cpu {cfg.name} {cfg.n_layers}L",
                half if half is not None else moe.half,
                time.perf_counter() - t_start)
    if strict and not ok:
        fail(f"card and CPU logits disagree ({cfg.name})")
    return readings


def card_vs_cpu_inputs(torch, cfg, seed):
    """Phase 5's inputs at ``cfg``: the weights of ``init_params`` (seed +
    1) at the true fan-in scale and 2 x 72 tokens, drawn on the CPU."""
    from repro_torch.models import build_model
    gen = torch.Generator().manual_seed(seed + 1)
    params = true_fan_in(build_model(cfg).init_params(gen, device="cpu"),
                         cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64 + 8), generator=gen)
    return params, toks


def card_vs_cpu_half(torch, cfg, seed):
    """The CPU side of :func:`card_vs_cpu` at a config without experts: its
    inputs and, for policies A and B, the CPU's teacher-forced logits and
    caches (``cpu_half``)."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    params, toks = card_vs_cpu_inputs(torch, cfg, seed)
    t1 = time.perf_counter()
    model = build_model(cfg)
    cpu = {label: _teacher_forced(torch, model, cfg, params, toks, policy,
                                  "cpu")
           for label, policy in (("A", "kv_cache=a8t,*=w8c"), ("B", POLICY))}
    return dict(params=params, toks=toks, cpu=cpu, draw_s=t1 - t0,
                cpu_s=time.perf_counter() - t1)


def _grad_scale(torch, g, fold, dim):
    """absmax / 127 of g * fold over ``dim``: the wrappers' q_scale."""
    absmax = (g.float().abs() * fold).amax(dim=dim, keepdim=True)
    return absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call with the host out of the way: the
    card sleeps while ``iters`` calls are queued behind it, then CUDA events
    time them back to back (the training step keeps the card's queue full,
    so this is what a call costs it; ``time_ms`` of a call shorter than its
    host dispatch times the host)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the kernels of one int8 backward call, by name, and the stage each is;
#: the GEMM and the reduction are shared with the forward
#: (``csrc/gemm_s8.cuh``), whose scale mode, 2, tells its kernels apart
BWD_STAGES = (("quant_rows_kernel", "quantize"), ("pack_tn_kernel", "quantize"),
              ("gemm_s8_kernel", "gemm"), ("split_reduce_kernel", "reduce"))
#: the kernels of one forward call (``csrc/int8_matmul.cu``): the cluster
#: route's one kernel, or the tensor-core route's transpose, GEMM and
#: reduction (and the first dp4a kernel, on no route)
FWD_STAGES = (("gemv_s8_kernel", "gemv"), ("int8_matmul_kernel", "dp4a"),
              ("transpose_kernel", "transpose"), ("gemm_s8_kernel", "gemm"),
              ("split_reduce_kernel", "reduce"))


def int8_kernel_side(name: str):
    """"fwd", "bwd" or None for a profiled kernel name: the forward's
    kernels (``FWD_STAGES``, the shared GEMM and reduction at scale mode 2,
    both scales) or the backward's (``BWD_STAGES``, modes 0 and 1)."""
    import re
    shared = ("gemm_s8_kernel" in name or "split_reduce_kernel" in name)
    if shared:
        both = re.search(r"_kernel<\s*(\(int\))?\s*2\s*,", name)
        return "fwd" if both else "bwd"
    if any(key in name for key, _ in FWD_STAGES):
        return "fwd"
    if any(key in name for key, _ in BWD_STAGES):
        return "bwd"
    return None


def bwd_stage_ms(torch, kind, g, other, fold, qs, k, n, dt) -> dict:
    """Each stage of one nt or tn call timed alone (``queued_ms``) through
    its stage wrapper: the quantize pass, the int8 GEMM (the split partials
    where the call splits) and the split reduction."""
    import importlib
    # the module (the package re-exports a function of its name)
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    m = g.shape[0]
    if kind == "nt":
        gq, wk = im.quant_rows_packed(g, fold, qs), im.kmajor_weight(other)
        return {"quantize": queued_ms(lambda: im.quant_rows_packed(g, fold,
                                                                    qs)),
                "gemm": queued_ms(lambda: im.int8_gemm_kmajor(
                    gq, wk, qs, n, True, dt, splits=1))}
    xt, gt = im.pack_tn(other, g, fold, qs)
    out = {"quantize": queued_ms(lambda: im.pack_tn(other, g, fold, qs))}
    splits = im.gemm_splits(k, n, m)
    if splits == 1:
        out["gemm"] = queued_ms(lambda: im.int8_gemm_kmajor(
            xt, gt, qs, m, False, dt, splits=1))
        return out
    ws = im.int8_gemm_partials(xt, gt, m, splits)
    out["gemm"] = queued_ms(lambda: im.int8_gemm_partials(xt, gt, m, splits))
    out["reduce"] = queued_ms(lambda: im.int8_split_reduce(ws, qs, False, dt))
    return out


def check_int8_bwd(torch, dev, gen, results, cases=None, tag=None,
                   phase=""):
    """Phase 6a: nt and tn at the training path's shapes (M = 8192 tokens,
    the three (K, N) of GPT-2 small's linears, bf16 gradient and output) and
    at fp32 (gradient and output, (768, 768)), bit for bit against their
    plain versions, a second launch bit-identical to the first; each timed
    with its stages (quantize pass, GEMM, split reduction) beside its bound,
    its plain version and ``torch._int_mm``, all with the card's queue
    full (``queued_ms``); every GEMM kernel of the library holds integer
    wgmma (``IGMMA``) in its SASS.  Phases 24a and 26a (``phase``):
    ``cases`` ((K, N, dtype) at M = 8192) under ``results[name][tag]``,
    the SASS left to phase 6."""
    from repro_torch.kernels.int8_matmul import (
        _quant_grad, gemm_splits, int8_matmul_nt, int8_matmul_nt_plain,
        int8_matmul_tn, int8_matmul_tn_plain, scale_guard)
    m = TRAIN_BATCH * TRAIN_SEQ
    rows = {"int8_matmul_nt": [], "int8_matmul_tn": []}
    label = f"phase {phase} " if phase else ""
    cases = cases or [(768, 768, torch.bfloat16), (768, 3072, torch.bfloat16),
                      (3072, 768, torch.bfloat16), (768, 768, torch.float32)]
    for k, n, dt in cases:
        g = (torch.randn((m, n), generator=gen, device=dev) * 0.02).to(dt)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        fw = torch.rand((1, n), generator=gen, device=dev) * 0.01 + 1e-4
        fx = torch.rand((m, 1), generator=gen, device=dev) * 0.05 + 1e-4
        qn = _grad_scale(torch, g, fw, 1)
        qt = _grad_scale(torch, g, fx, 0)
        es = g.element_size()
        kern_cases = {
            "int8_matmul_nt": (
                lambda: int8_matmul_nt(g, w, fw, qn, out_dtype=dt),
                lambda: int8_matmul_nt_plain(g, w, fw, qn, out_dtype=dt),
                # yardstick operands: the quantized gradient, w^T
                (_quant_grad(g, fw, scale_guard(qn)).to(torch.int8),
                 w.t()),
                m * n * es + k * n + 4 * (n + m) + m * k * es, 1,
                lambda: bwd_stage_ms(torch, "nt", g, w, fw, qn, k, n, dt)),
            "int8_matmul_tn": (
                lambda: int8_matmul_tn(x, g, fx, qt, out_dtype=dt),
                lambda: int8_matmul_tn_plain(x, g, fx, qt, out_dtype=dt),
                (x.t().contiguous(),
                 _quant_grad(g, fx, scale_guard(qt)).to(torch.int8)),
                m * k + m * n * es + 4 * (m + n) + k * n * es,
                gemm_splits(k, n, m),
                lambda: bwd_stage_ms(torch, "tn", g, x, fx, qt, k, n, dt)),
        }
        for name, (kern, plain, (la, lb), nbytes, splits,
                   stages) in kern_cases.items():
            got, want = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                fail(f"{label}{name} M={m} K={k} N={n} {dt} not bit-exact "
                     f"(max err {err})")
            if not torch.equal(again, got):
                fail(f"{label}{name} M={m} K={k} N={n} {dt}: a second launch "
                     f"gave other bits")
            ms = queued_ms(kern)
            split = stages()
            plain_ms = time_ms(plain, iters=3)
            lib = queued_ms(lambda: torch._int_mm(la, lb))
            b, by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS)
            rows[name].append(dict(shape=f"M={m},K={k},N={n},{dt}",
                                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b, bound_by=by, library_ms=lib,
                                   stages_ms=split, splits=splits))
            print(f"{label}{name} M={m} K={k:4d} N={n:4d} {str(dt)[6:]}: "
                  f"bit-exact "
                  f"(tol 0), repeat bit-identical, ms {ms:.4f} (stages alone: "
                  + ", ".join(f"{st} {v:.4f}" for st, v in split.items())
                  + f"; {splits} split{'s' if splits > 1 else ''}), plain_ms "
                  f"{plain_ms:.4f}, bound_ms {b:.5f} ({by}), "
                  f"library_ms(_int_mm) {lib:.4f}")
    if tag:
        for name in rows:
            results[name][tag] = dict(shapes=rows[name])
        return
    # the JSON entry reports the shape with the most launches on the main
    # path: wq, wk, wv and wo at K = N = 768 (48 of the 72 a step)
    for name, line in (("int8_matmul_nt", 146), ("int8_matmul_tn", 205)):
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/int8_matmul_bwd.cu",
            replaces=f"src/repro/kernels/int8_matmul.py:{line}", tol=0.0,
            shapes=rows[name], **rows[name][0])
    counts = sass_counts("int8_matmul_bwd", "IGMMA")
    gemm = {fn: c for fn, c in counts.items() if "gemm_s8_kernel" in fn}
    print(f"int8_matmul_bwd SASS: {sum(gemm.values())} IGMMA instructions "
          f"over {len(gemm)} GEMM kernels (each "
          f"{min(gemm.values(), default=0)}-{max(gemm.values(), default=0)})")
    if not gemm or min(gemm.values()) == 0:
        fail(f"phase 6: an int8 backward GEMM kernel has no IGMMA: {gemm}")


#: phase 6b's bucket rows are padded to a multiple of this: the JAX
#: reference's tile (``repro/optim/adamw.py``), as the port padded its
#: bucket before it read the leaves where they lie
BUCKET_TILE_ROWS = 256


def gpt2_bucket_rows(torch, dev, cfg):
    """(rows, params) of the fused AdamW bucket for ``cfg`` under 128-wide
    blocks: every quantizable leaf's blocks, padded to the reference's
    tile, and the parameters they hold."""
    from repro_torch.core import qadam
    from repro_torch.core.qconfig import parse_spec
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    spec = parse_spec("8c-b128")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = tree_flatten(params)[0]
    rows = sum(qadam.blockwise_state_shapes(p.shape, spec)[0][0]
               for p in leaves if qadam.quantizable(p))
    n_params = sum(p.numel() for p in leaves if qadam.quantizable(p))
    del params, leaves
    return rows + (-rows) % BUCKET_TILE_ROWS, n_params


def gpt2_leaves(torch, dev, gen, rec, seed=0, arch="gpt2-small"):
    """GPT-2 small's (``arch``'s) quantizable leaves as the optimizer reads
    them: params from ``init_params`` (``seed``), random fp32 gradients,
    and both moments of random values quantized per leaf with ``rec``'s
    codecs (m2 through its sqrt domain).  A dict of lists: g, p, m1, m2
    (QStates)."""
    from repro_torch.configs import get_config
    from repro_torch.core import qadam
    from repro_torch.core.quantizer import quantize_int
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    params = build_model(get_config(arch)).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    p = [t for t in tree_flatten(params)[0] if qadam.quantizable(t)]
    del params

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return {"p": p, "g": [rand(t.shape, 1e-2) for t in p],
            "m1": [qadam.QState(*quantize_int(rand(t.shape, 1e-3),
                                              rec.adam_m1)) for t in p],
            "m2": [qadam.QState(*quantize_int(
                torch.rand(t.shape, generator=gen, device=dev).mul_(
                    1e-5).sqrt_(), rec.adam_m2)) for t in p]}


def _leaves_out(out):
    """The tensors of a ``fused_adamw_leaves`` result, in order."""
    p, m1, m2, _ = out
    return [*p, *(t for m in m1 for t in m), *(t for m in m2 for t in m)]


def _same(torch, got, want):
    """(bit for bit?, max |difference|) over two lists of tensors."""
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    return all(torch.equal(a, b) for a, b in zip(got, want)), err


def optimizer_device_time(torch, call, reps: int = 5):
    """Device time of one optimizer call with the card's queue full: the
    card sleeps while the host queues the whole call, then CUDA events
    time it (the median of ``reps``); and torch.profiler's device time of
    its kernels over one more call, by kind.  Returns (ms, {kind: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        low = e.key.lower()
        kind = ("fused AdamW kernel" if "adamw" in low else
                "concatenation" if "cat" in low else
                "reductions" if "reduce" in low else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    return sorted(times)[reps // 2], kinds


def check_fused_adamw(torch, dev, gen, results):
    """Phase 6b: the fused AdamW kernel's two entries on GPT-2 small.

    The bucket entry on a bucket of GPT-2 small's size (random gradient,
    params and moments; the slice's codecs) and the leaves entry on GPT-2
    small's own quantizable leaves (``gpt2_leaves``: params from
    ``init_params``, random fp32 gradients, moments quantized per leaf), a
    second step from the first one's outputs (views into its bucket), each
    bit for bit against its plain version in params, payloads, scales and
    zero points, the update-norm sum within 1e-5 relative (another
    summation order), and a repeat bit-identical (the sum too).  Both
    timed queued beside the byte bound; then ``adamw_update`` on GPT-2
    small's params and the train policy: its device time with the card's
    queue full and its kernels by kind (``optimizer_device_time``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qconfig import parse_recipe
    from repro_torch.core.quantizer import quantize_int
    from repro_torch.kernels.opt_update import (codec_of, fused_adamw_blocks,
                                                fused_adamw_blocks_plain,
                                                fused_adamw_leaves,
                                                fused_adamw_leaves_plain)
    rec = parse_recipe("m1:8c-b128,m2:8c-asym-b128-sqrt")
    rows, n_params = gpt2_bucket_rows(torch, dev, get_config("gpt2-small"))
    bs = 128
    g = torch.randn((rows, bs), generator=gen, device=dev) * 1e-2
    p = torch.randn((rows, bs), generator=gen, device=dev) * 0.05
    m1 = torch.randn((rows, bs), generator=gen, device=dev) * 1e-3
    m2 = torch.rand((rows, bs), generator=gen, device=dev) * 1e-5
    bucket = [g, p, *quantize_int(m1, rec.adam_m1),
              *quantize_int(m2.sqrt(), rec.adam_m2)]
    del m1, m2
    sc = torch.tensor([0.7, 6e-4, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                       1 - 0.95 ** 3], dtype=torch.float32, device=dev)
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)

    def sum_rel(got, want):
        return abs(got.item() - want.item()) / want.item()
    ref = [t.clone() for t in bucket]
    again = [t.clone() for t in bucket]
    got = fused_adamw_blocks(*bucket, sc, **kw)
    want = fused_adamw_blocks_plain(*ref, sc, **kw)
    rep = fused_adamw_blocks(*again, sc, **kw)
    torch.cuda.synchronize()
    exact, err = _same(torch, bucket[1:], ref[1:])
    if not exact:
        fail(f"fused_adamw_blocks not bit-exact on {rows} x {bs} (max err "
             f"{err})")
    rel = sum_rel(got[3], want[3])
    if rel > 1e-5:
        fail(f"fused_adamw_blocks update-norm sum off by {rel:.2e} relative")
    if not (_same(torch, again[1:], bucket[1:])[0]
            and torch.equal(rep[3], got[3])):
        fail("fused_adamw_blocks: a repeat is not bit-identical")
    del ref, again
    ms = queued_ms(lambda: fused_adamw_blocks(*bucket, sc, **kw), iters=10)
    plain = time_ms(lambda: fused_adamw_blocks_plain(*bucket, sc, **kw),
                    iters=3)
    n = rows * bs
    # reads g, p (fp32) and both int8 payloads, writes p and both payloads;
    # scale and zero of both moments read and written once a row
    nbytes = n * (4 + 4 + 1 + 1 + 4 + 1 + 1) + rows * 4 * 4 * 2 + 8 * 4
    b, by = bound_ms(nbytes, 35.0 * n, FP32_FLOPS)
    print(f"fused_adamw_blocks {rows} x {bs} ({n_params} GPT-2 small params "
          f"in the bucket): bit-exact (tol 0; update-norm sum rel "
          f"{rel:.1e}, tol 1e-5), repeat bit-identical, queued ms "
          f"{ms:.4f}, plain_ms {plain:.4f}, bound_ms {b:.5f} ({by}), "
          f"library_ms none (no PyTorch call computes blockwise 8-bit AdamW)")
    results["fused_adamw_blocks"] = dict(
        route="cuda", source="src/repro_torch/csrc/opt_update.cu",
        replaces="src/repro/kernels/opt_update.py:160", tol=0.0,
        shape=f"rows={rows},bs={bs}", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None)
    del bucket, got, want, rep, g, p

    lv = gpt2_leaves(torch, dev, gen, rec)
    args = (lv["g"], lv["p"], lv["m1"], lv["m2"], sc)
    first = fused_adamw_leaves(*args, **kw)
    errs = []
    for step, (got, want) in enumerate((
            (first, fused_adamw_leaves_plain(*args, **kw)),
            # the optimizer's steady state: moments and params are views
            # into the previous step's bucket
            (fused_adamw_leaves(lv["g"], *first[:3], sc, **kw),
             fused_adamw_leaves_plain(lv["g"], *first[:3], sc, **kw)))):
        torch.cuda.synchronize()
        exact, e = _same(torch, _leaves_out(got), _leaves_out(want))
        errs.append(e)
        if not exact:
            fail(f"fused_adamw_leaves step {step + 1} not bit-exact on "
                 f"{len(lv['p'])} leaves (max err {e})")
        rel_l = sum_rel(got[3], want[3])
        if rel_l > 1e-5:
            fail(f"fused_adamw_leaves step {step + 1} update-norm sum off by "
                 f"{rel_l:.2e} relative")
    rep = fused_adamw_leaves(*args, **kw)
    if not (_same(torch, _leaves_out(rep), _leaves_out(first))[0]
            and torch.equal(rep[3], first[3])):
        fail("fused_adamw_leaves: a repeat is not bit-identical")
    del rep, got, want
    rows_l = sum(int(m.q.shape[0]) for m in lv["m1"])
    ms_l = queued_ms(lambda: fused_adamw_leaves(*args, **kw), iters=10)
    plain_l = time_ms(lambda: fused_adamw_leaves_plain(*args, **kw), iters=3)
    n_l = rows_l * bs
    b_l, by_l = bound_ms(n_l * 16 + rows_l * 32 + 32, 35.0 * n_l, FP32_FLOPS)
    print(f"fused_adamw_leaves {len(lv['p'])} GPT-2 small leaves ({rows_l} "
          f"rows of {bs}, none padded): two steps bit-exact (tol 0; "
          f"update-norm sum rel {rel_l:.1e}, tol 1e-5), repeat "
          f"bit-identical, queued ms {ms_l:.4f}, plain_ms {plain_l:.4f} "
          f"(concatenation included), bound_ms {b_l:.5f} ({by_l}), "
          f"library_ms none")
    results["fused_adamw_leaves"] = dict(
        route="cuda", source="src/repro_torch/csrc/opt_update.cu",
        replaces="src/repro/kernels/opt_update.py:160", tol=0.0,
        shape=f"leaves={len(lv['p'])},rows={rows_l},bs={bs}",
        max_abs_err=max(errs), ms=ms_l, plain_ms=plain_l, bound_ms=b_l,
        bound_by=by_l, library_ms=None)
    del lv, args, first
    bulk_sass_check(("opt_update", "adamw_stream_kernel"))
    adamw_update_time(torch, dev, gen)


def adamw_update_time(torch, dev, gen):
    """Phase 6b's last part: one ``adamw_update`` on GPT-2 small's params
    (``init_params``, seed 0), random fp32 gradients and fresh int8
    moments under ``TRAIN_POLICY``, the call phase 7's step makes: its
    device time with the card's queue full, its kernels by kind."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import adamw_update, init_adam_state
    from repro_torch.core.qpolicy import as_policy
    policy = as_policy(TRAIN_POLICY)
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=TRAIN_STEPS,
                    state_storage="int")
    params = build_model(get_config("gpt2-small")).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev) * 1e-2, params)
    state = init_adam_state(params, policy, opt)
    ms, kinds = optimizer_device_time(
        torch, lambda: adamw_update(params, grads, state, opt, policy))
    print(f"adamw_update on GPT-2 small ({TRAIN_POLICY.split('@')[0]}): "
          f"device {ms:.4f} ms a call with the queue full; kernels by kind "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(kinds.items())))


def train_launches(cfg):
    """The launches of one train step on the int8 kernels: each 2-D block
    linear's forward (#3) once, and once more in the backward under
    ``cfg.remat`` (the layer's recomputation); its backward (#4, #5) once
    (an SSM layer's five projections likewise, and no attention kernel;
    the hybrid's too, and the shared block's eight linears at each of its
    n_layers / hybrid_attn_every invocations); with experts, the three
    expert projections likewise on the expert-batched #3, #4 and #5 (the
    attention's four linears on the 2-D ones); one ``fused_adamw_leaves``
    (#6); under ``flash_pallas`` the flash forward (#8) once an attention
    call (a layer's, or a shared-block invocation's), again under
    ``remat``, and its backward (#9, #10) once.  The encoder-decoder: its
    blocks' linears and flash calls as above (an encoder block one
    attention call, a decoder block two), ``frame_proj`` once each way."""
    attn_calls = cfg.n_layers
    if cfg.family == "encdec":
        # frame_proj, an encoder layer's six linears, a decoder layer's ten
        # (self-attention, cross-attention, MLP); frame_proj runs outside
        # every checkpoint, so it runs once; one flash call an encoder layer
        # and two a decoder layer (self and cross)
        again = 2 if cfg.remat else 1
        blocks = 6 * cfg.enc_layers + 10 * cfg.n_layers
        calls = cfg.enc_layers + 2 * cfg.n_layers
        extra = {}
        if cfg.attention_impl == "flash_pallas":
            extra = dict(flash_attention_fwd_lse=again * calls,
                         flash_attention_bwd_dkdv=calls,
                         flash_attention_bwd_dq=calls)
        return _expect(int8_matmul=again * blocks + 1,
                       int8_matmul_nt=blocks + 1, int8_matmul_tn=blocks + 1,
                       fused_adamw_leaves=1, **extra)
    if cfg.family in ("ssm", "hybrid"):
        per_layer = SSM_LINEARS
        attn_calls = (cfg.n_layers // cfg.hybrid_attn_every
                      if cfg.family == "hybrid" else 0)
    elif cfg.n_experts:
        per_layer = MOE_ATTN_LINEARS
    else:
        per_layer = 7 if cfg.mlp_kind == "gated" else 6
    linears, again = per_layer * cfg.n_layers, 2 if cfg.remat else 1
    if cfg.family == "hybrid":
        linears += HYBRID_SHARED_LINEARS * attn_calls
    extra = {}
    if cfg.attention_impl == "flash_pallas" and attn_calls:
        extra = dict(flash_attention_fwd_lse=again * attn_calls,
                     flash_attention_bwd_dkdv=attn_calls,
                     flash_attention_bwd_dq=attn_calls)
    if cfg.n_experts:
        experts = EXPERT_PROJECTIONS * cfg.n_layers
        extra.update(int8_matmul_experts=again * experts,
                     int8_matmul_nt_experts=experts,
                     int8_matmul_tn_experts=experts)
    return _expect(int8_matmul=again * linears, int8_matmul_nt=linears,
                   int8_matmul_tn=linears, fused_adamw_leaves=1, **extra)


@contextlib.contextmanager
def libraries_loaded():
    """Yields the set of library names that ``_build.load`` is asked for
    inside the block: every kernel launch looks its library up, so it names
    the libraries a path ran on."""
    from repro_torch.kernels import _build
    names, real = set(), _build.load

    def load(name):
        names.add(name)
        return real(name)
    _build.load = load
    try:
        yield names
    finally:
        _build.load = real


def train(torch, dev, seed, impl="xla", cfg=None, batch=TRAIN_BATCH,
          seq=TRAIN_SEQ, steps=TRAIN_STEPS, tag=None, profile=True):
    """Phase 7 (``impl="xla"``, attention through ``_attend``) and phase 14
    (``"flash_pallas"``, through #8-#10): GPT-2 small's train step on the
    card (``gpt2_train_cfg``); phases 18a and 18c: ``cfg`` at (``batch``,
    ``seq``) for ``steps`` steps.  Every step's ce and grad norm finite and
    its launches exactly ``train_launches(cfg)``; ms per step (step 1,
    which loads the libraries, left out), tokens/s and peak memory, then
    with ``profile`` one profiled step.  Returns the launch counts of the
    main run."""
    from repro_torch import kernels
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   train_path_summary)
    cfg = cfg or gpt2_train_cfg(attention_impl=impl)
    model = build_model(cfg)
    tag = tag or ("train" if impl == "xla" else "train_flash")
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=steps,
                    state_storage="int")
    # the serving phases stopped their schedulers (a running emit thread
    # holds its engine), but an engine and its scheduler refer to each
    # other: collect the cycles so the peak below is the train step's own
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(model,
                             torch.Generator(device=dev).manual_seed(seed),
                             TRAIN_POLICY, opt, device=dev)
    step_fn = make_train_step(model, TRAIN_POLICY, opt)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=batch, seq_len=seq)
    # every leaf of the loader's batches (the encoder-decoder's frames too)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(loader).items()} for _ in range(steps + 1)]
    summary = train_path_summary(TRAIN_POLICY, cfg.n_layers, opt, device=dev,
                                 cfg=cfg, batch=batch, seq=seq)
    print(f"{tag}: {cfg.name} {cfg.n_layers}L d={cfg.d_model} carrier "
          f"{cfg.dtype}, attention {cfg.attention_impl}, {batch} x {seq} "
          f"tokens a step, policy {TRAIN_POLICY}, int moments; train-path: "
          f"{summary}")
    want = train_launches(cfg)
    print(f"{tag}: launches a step, as the design predicts: "
          f"{ {k: v for k, v in want.items() if v} }")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_ms = []
    for i in range(steps):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        state, met = step_fn(state, batches[i])
        ce, gn = float(met["ce"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        print(f"{tag}: step {i + 1:2d} ce {ce:.4f} grad_norm {gn:.4f} "
              f"update_norm {float(met['update_norm']):.4f} "
              f"{step_ms[-1]:.1f} ms")
        if not (math.isfinite(ce) and math.isfinite(gn)):
            fail(f"{tag} step {i + 1}: ce {ce}, grad norm {gn}")
        if per != want:
            fail(f"{tag} step {i + 1}: launches {per}, expected {want}")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = step_ms[1:]
    mean = sum(steady) / len(steady)
    tok = batch * seq
    print(f"{tag}: {steps} steps, step 1 {step_ms[0]:.1f} ms (loads "
          f"the libraries), steps 2-{steps} mean {mean:.1f} ms "
          f"(min {min(steady):.1f}, max {max(steady):.1f}), "
          f"{tok / mean * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB")
    print(f"{tag}: launch counts {counts}")
    if profile:
        profile_train_step(torch, step_fn, state, batches[-1])
    return counts


def profile_train_step(torch, step_fn, state, batch) -> None:
    """Where a train step's time goes: torch.profiler over one step after
    the main run's counts are read (``profile_device``)."""
    profile_device(torch, lambda: step_fn(
        state, batch if isinstance(batch, dict) else {"tokens": batch}),
        "1 train step")


def profile_device(torch, fn, what: str) -> None:
    """Device time by kernel over one call of ``fn`` and the device's idle
    share of its wall time.  The profiler records the card's activity alone
    and its kernel records are read raw: at Zamba2-2.7B's 74,610 launches,
    recording the host's ops too and parsing the events with
    ``key_averages()`` took 57.6 s, the card's alone 20.6 s, read raw 2.7
    s, with the same kernels, busy time and launches
    (``tools/profile_cost.py``; H100 80GB HBM3, 700 W)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    kern = [(name, us, n) for name, (us, n) in by_name.items()]
    busy = sum(k[1] for k in kern)
    if not busy:
        print("profile: no device time recorded (not measured)")
        return
    kern.sort(key=lambda k: -k[1])
    print(f"profile: {what}, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{sum(k[2] for k in kern)} kernel launches")
    # the twelve largest, and every flash kernel, every kernel of the int8
    # forward and backward and the fused AdamW (#6) wherever it ranks
    side = {k[0]: int8_kernel_side(k[0]) for k in kern}
    for rank, (name, us, n) in enumerate(kern):
        if (rank < 12 or "flash" in name or side[name]
                or "adamw_stream_kernel" in name):
            print(f"profile:   {us / 1e3:8.3f} ms {n:5d} launches "
                  f"{name[:90]}")
    for key, part in (("fwd", "the int8 forward (int8_matmul)"),
                      ("bwd", "the int8 backward (nt and tn)")):
        ks = [k for k in kern if side[k[0]] == key]
        print(f"profile: {part} {sum(k[1] for k in ks) / 1e3:.3f} ms in "
              f"{sum(k[2] for k in ks)} launches")


def _rel_l2(torch, a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors, in float64 on the device of
    each tensor of ``a`` (the card's, where a card result meets a CPU one:
    Yi-6B's leaves are too many for the CPU's float64 passes)."""
    num = den = 0.0
    for x, y in zip(a, b):
        y = y.to(x.device).double()
        num += float((x.double() - y).square().sum())
        den += float(y.square().sum())
    return math.sqrt(num / max(den, 1e-300))


def _update_split(torch, card, cpu):
    """Where the parameter updates of the card and the CPU part: the share
    of elements whose gradient sign differs, the share whose sign agrees
    but whose m1 or m2 payload differs, and the updates' relative L2
    distance over the elements whose sign agrees (on ``card``'s device,
    in float64)."""
    from repro_torch.core.qadam import QState
    n_all = n_flip = n_pay = 0
    num_s = den_s = 0.0
    for i, (gc, gp) in enumerate(zip(card["grads"], cpu["grads"])):
        dev, n = gc.device, gp.numel()
        flip = (torch.sign(gc).reshape(-1)
                != torch.sign(gp.to(dev)).reshape(-1))
        pay = torch.zeros(n, dtype=torch.bool, device=dev)
        for key in ("m1", "m2"):
            a, b = card[key][i], cpu[key][i]
            if isinstance(b, QState):
                pay |= (a.q.reshape(-1)[:n] != b.q.to(dev).reshape(-1)[:n])
        uc = (card["p"][i] - card["p0"][i]).double().reshape(-1)
        up = (cpu["p"][i] - cpu["p0"][i]).to(dev).double().reshape(-1)
        d2, u2 = (uc - up).square(), up.square()
        same = ~flip
        n_all, n_flip = n_all + n, n_flip + int(flip.sum())
        n_pay += int((same & pay).sum())
        num_s += float(d2[same].sum())
        den_s += float(u2[same].sum())
    return (n_flip / n_all, n_pay / n_all,
            math.sqrt(num_s / max(den_s, 1e-300)))


def one_train_step(torch, model, policy, params, toks, opt, device,
                   fused=None, swap=()):
    """One train step's forward, backward and AdamW update from ``params``
    (CPU tensors, copied to ``device``; ``toks`` the tokens, or a batch
    dict whose leaves are copied too) and fresh moments, with the named
    kernels' plain versions in their place (``plain_versions``): loss,
    flat gradients, params before and after, new moments, grad norm."""
    from repro_torch.models.common import tree_flatten, tree_map
    from repro_torch.optim.adamw import adamw_update, init_adam_state
    from repro_torch.train.step import value_and_grad
    p = tree_map(lambda t: t.to(device), params)
    st = init_adam_state(p, policy, opt)
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    with plain_versions(swap):
        loss, _, grads = value_and_grad(model, policy, p,
                                        {k: v.to(device)
                                         for k, v in batch.items()})
        new_p, new_st, stats = adamw_update(p, grads, st, opt, policy,
                                            fused=fused)
    return dict(loss=float(loss), grads=tree_flatten(grads)[0],
                p0=tree_flatten(p)[0], p=tree_flatten(new_p)[0],
                m1=tree_flatten(new_st.m1)[0], m2=tree_flatten(new_st.m2)[0],
                gn=float(stats["grad_norm"]), p_tree=p, g_tree=grads, st=st)


def train_card_vs_cpu(torch, dev, seed, cfg=None, batch=4, seq=128,
                      limits=TRAIN_LIMITS, label="phase 8", control=(),
                      zero_points=True, strict=True, plain_check=False,
                      extra=None):
    """Phase 8: one train step of gpt2-mini (float32 carrier, batch 4 x 128
    from the synthetic corpus, the slice's policy, int moments), weights of
    ``init_params`` (seed + 2) at the true fan-in scale (``true_fan_in``,
    as phase 5), the same on both devices; phase 18d: ``cfg`` (Yi-6B's
    width at 2 layers, ``remat`` on) at (``batch``, ``seq``) with
    ``limits``.  Returns A's distances (``_step_distance``); ``strict=False``
    reports instead of failing (``tools/yi_train_readings.py``).

    A. the card (kernels) against the CPU (plain versions): |d ce|, the
       gradients' relative L2 distance, the share of elements whose
       gradient sign differs, and the parameter updates' relative L2
       distance over all elements and over those whose sign agrees, each
       within a fixed limit (``TRAIN_LIMITS``);
    B. the card twice, the second time with only ``int8_matmul_nt`` and
       ``int8_matmul_tn`` swapped for their plain versions: every gradient
       bit-identical (and the card run twice without a swap, the control,
       bit-identical too);
    C. on the card, the fused AdamW path against the reference loop on the
       same gradients: params within 1e-6 relative (to each leaf's largest
       magnitude), payloads at most one codec step apart, scales within
       1e-6 relative -- the AdamW limits of
       tests/test_torch_train.py (the loop rounds 1 - b1 in Python
       float64, the kernel in float32, so moments can differ by an ulp).

    ``zero_points=False`` (phase 18d) holds C's payloads to one step only
    where the block's asymmetric zero points agree, and the dequantized
    moments to one step everywhere: the loop's 1 - b2 (Python float64)
    and the kernel's (float32) part by 1.3e-5 relative, and over Yi-6B's
    870 M moments a zero point flips by one while a payload flips the
    other way.

    With ``control`` (a tuple of A's distances), D: the same step on the
    card at the bf16 carrier against the same CPU step, each of those
    distances above its limit (as phase 12's control), so A would see a
    step that lost the float32 carrier's precision.

    With experts (phase 22d) the card's first run records its routes
    (``routes_recorded``) and every other run replays them
    (``routes_replayed``): a near-tied router logit flipped by a last bit
    would send a token to another expert and move the step by as much as
    the carrier does (phase 21d).  B then swaps the expert-batched #4 and
    #5 too.  ``plain_check`` adds E: the step on the card with every
    kernel of the path in its plain version, against the CPU, within A's
    limits.  ``extra`` (a dict) receives E's and D's distances as
    ``"plain"`` and ``"control"``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qadam import QState
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim.adamw import adamw_update
    cfg = cfg or dataclasses.replace(get_smoke_config("gpt2-small"),
                                     dtype="float32")
    model = build_model(cfg)
    t_start = time.perf_counter()
    if cfg.n_experts:
        # the CPU replays the card's routes: its side waits for the card
        params, toks = train_check_inputs(torch, cfg, seed, batch, seq)
        half, moe = None, _inline_half(t_start)
    else:
        half = cpu_half("train_check_half", cfg, seed, batch, seq)
        params, toks = half["params"], half["batch"]
    opt = _check_opt()
    policy = as_policy(TRAIN_POLICY)
    what = (f"{cfg.name} {cfg.n_layers}L d={cfg.d_model}, float32 carrier, "
            f"{batch} x {seq} tokens, remat {cfg.remat}")

    card_routes = [] if cfg.n_experts else None

    def run(device, fused=True, swap=(), m=model, record=False):
        routes = (routes_recorded(card_routes) if record
                  else routes_replayed(card_routes) if card_routes is not None
                  else contextlib.nullcontext())
        with routes:
            return one_train_step(torch, m, policy, params, toks, opt,
                                  device, fused=fused, swap=swap)

    card = run(dev, record=True)
    if half is not None:
        cpu = half["cpu"]
    else:
        with moe.cpu():
            cpu = run("cpu")
    dist = _step_distance(torch, card, cpu)
    d_ce, g_rel, u_rel, flips, u_sign, pays = (dist[k] for k in (
        "ce", "grads", "updates", "sign_flips", "updates_sign", "payloads"))
    lim = limits
    print(f"{label} train card vs cpu A ({what}, {TRAIN_POLICY}): ce "
          f"{card['loss']:.6f} vs {cpu['loss']:.6f} "
          f"(|d| {d_ce:.3e}, limit {lim['ce']:.1e}), grad norm "
          f"{card['gn']:.6f} vs {cpu['gn']:.6f}, grads rel L2 {g_rel:.3e} "
          f"(limit {lim['grads']:.1e}), param updates rel L2 {u_rel:.3e} "
          f"(limit {lim['updates']:.1e})")
    print(f"{label} train card vs cpu A, updates by element: gradient sign "
          f"differs "
          f"on {flips:.3e} of them (limit {lim['sign_flips']:.1e}); updates "
          f"rel L2 where the sign agrees {u_sign:.3e} (limit "
          f"{lim['updates_sign']:.1e}), though an m1/m2 payload differs on "
          f"{pays:.3e} of the elements there")
    ok = (d_ce <= lim["ce"] and g_rel <= lim["grads"]
          and u_rel <= lim["updates"] and flips <= lim["sign_flips"]
          and u_sign <= lim["updates_sign"])

    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(a["grads"], b["grads"]))
    ctrl_same = same(card, run(dev))
    bwd = ("int8_matmul_nt", "int8_matmul_tn")
    if cfg.n_experts:
        bwd += ("int8_matmul_nt_experts", "int8_matmul_tn_experts")
    swapped = run(dev, swap=bwd)
    swap_same = same(card, swapped)
    print(f"{label} train card vs card B: grads with plain "
          f"{', '.join(bwd)} in the kernels' place "
          f"{'bit-identical' if swap_same else 'DIFFER'} "
          f"(control, the card twice: "
          f"{'bit-identical' if ctrl_same else 'DIFFER'}; tol 0; grads rel "
          f"L2 {_rel_l2(torch, swapped['grads'], card['grads']):.3e})")
    del swapped
    ok &= ctrl_same and swap_same

    # C: same gradients, fused kernel against the loop
    loop_p, loop_st, _ = adamw_update(card["p_tree"], card["g_tree"],
                                      card["st"], opt, policy, fused=False)
    lp, lm1, lm2 = (tree_flatten(t)[0] for t in (loop_p, loop_st.m1,
                                                 loop_st.m2))
    # params relative to each leaf's largest magnitude: elementwise, a value
    # where p - lr * update cancels would magnify an ulp of the update
    p_rel = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(card["p"], lp))
    dq = dq_zero = n_two = n_two_zero = 0
    s_rel = steps = 0.0
    deq = lambda m: m.scale * (m.q.float() + m.zero)
    for fa, la in zip(card["m1"] + card["m2"], lm1 + lm2):
        if isinstance(fa, QState):
            d = (fa.q.int() - la.q.int()).abs()
            zero_same = (fa.zero == la.zero).expand_as(d)
            dq = max(dq, d.max().item())
            dq_zero = max(dq_zero, (d * zero_same).max().item())
            n_two += int((d >= 2).sum())
            n_two_zero += int(((d >= 2) & ~zero_same).sum())
            s_rel = max(s_rel, ((fa.scale - la.scale).abs()
                                / la.scale.abs().clamp_min(1e-30)).max().item())
            steps = max(steps, ((deq(fa) - deq(la)).abs()
                                / la.scale.clamp_min(1e-30)).max().item())
    print(f"{label} train card C: fused AdamW vs the loop on the card, same "
          f"grads: params max rel {p_rel:.2e} (limit 1e-6), payloads max "
          f"{dq} step (limit {'1' if zero_points else 'not set'}), where the "
          f"block's zero points agree {dq_zero} (limit 1); {n_two} payloads "
          f"2+ steps apart, {n_two_zero} of them where the zero points "
          f"differ; dequantized moments max {steps:.4f} of a step apart "
          f"(limit {'not set' if zero_points else '1.001'}); scales max rel "
          f"{s_rel:.2e} (limit 1e-6)")
    ok &= p_rel <= 1e-6 and dq_zero <= 1 and s_rel <= 1e-6
    ok &= dq <= 1 if zero_points else steps <= 1.001
    del loop_p, loop_st, lp, lm1, lm2
    bad = []
    names = {"ce": "|d ce|", "grads": "grads rel L2",
             "sign_flips": "sign flips", "updates": "updates rel L2",
             "updates_sign": "updates rel L2 where the sign agrees"}
    if plain_check:
        kinds = TRAIN_KERNELS + ("int8_matmul", "int8_matmul_experts")
        if cfg.attention_impl == "flash_pallas":
            kinds += FLASH_KERNELS
        plain = run(dev, swap=kinds)
        plain_dist = _step_distance(torch, plain, cpu)
        plain_ok = all(plain_dist[k] <= lim[k] for k in names)
        print(f"{label} train E, every kernel of the path in its plain "
              f"version on the card vs cpu: "
              + ", ".join(f"{names[k]} {plain_dist[k]:.3e} (limit "
                          f"{lim[k]:.1e})" for k in names)
              + f": within {'yes' if plain_ok else 'NO'}")
        if extra is not None:
            extra["plain"] = plain_dist
        del plain
        if not plain_ok:
            bad.append("the plain versions on the card lie outside the "
                       "limits")
    if control:
        low = run(dev, m=build_model(dataclasses.replace(cfg,
                                                         dtype="bfloat16")))
        low_dist = _step_distance(torch, low, cpu)
        if extra is not None:
            extra["control"] = low_dist
        low_ok = all(low_dist[k] > lim[k] for k in control)
        print(f"{label} train control D, the card at the bf16 carrier vs "
              f"cpu: ce {low['loss']:.6f}, "
              + ", ".join(f"{names[k]} {low_dist[k]:.3e} (limit "
                          f"{lim[k]:.1e})" for k in names)
              + f": {', '.join(control)} above their limits "
              f"{'yes' if low_ok else 'NO'}")
        if not low_ok:
            bad.append("the bf16-carrier control lies within the limits, so "
                       "they cannot tell it from a sound step")
    if not ok:
        bad.append("train step card vs CPU / card vs card out of limits")
    print_split(f"{label} train card vs cpu",
                half if half is not None else moe.half,
                time.perf_counter() - t_start)
    if bad and strict:
        fail(f"{label}: {'; '.join(bad)}")
    for msg in bad:
        print(f"chip_smoke: {label}: {msg}")
    return dist


def _check_opt():
    from repro_torch.optim import OptConfig
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                     state_storage="int")


def train_check_inputs(torch, cfg, seed, batch, seq):
    """Phase 8's inputs at ``cfg``: the weights of ``init_params`` (seed +
    2) at the true fan-in scale, drawn on the CPU, and step 0 of the
    synthetic corpus (``batch`` x ``seq`` tokens; the encoder-decoder's
    batch also its frames, as the loader draws them)."""
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    params = true_fan_in(build_model(cfg).init_params(
        torch.Generator().manual_seed(seed + 2), device="cpu"), cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=7)
    toks = torch.from_numpy(corpus.batch(0, batch_size=batch, seq_len=seq))
    if cfg.family != "encdec":
        return params, toks
    frames = Loader(corpus, cfg, batch_size=batch, seq_len=seq).peek(0)
    return params, {"frames": torch.from_numpy(frames["frames"]),
                    "tokens": toks}


def train_check_half(torch, cfg, seed, batch, seq):
    """The CPU side of :func:`train_card_vs_cpu` at a config without
    experts: its inputs and the CPU's train step, the fields the checks
    read (``cpu_half``)."""
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    params, toks = train_check_inputs(torch, cfg, seed, batch, seq)
    t1 = time.perf_counter()
    out = one_train_step(torch, build_model(cfg), as_policy(TRAIN_POLICY),
                         params, toks, _check_opt(), "cpu")
    cpu = {k: out[k] for k in ("loss", "gn", "grads", "p0", "p", "m1",
                               "m2")}
    return dict(params=params, batch=toks, cpu=cpu, draw_s=t1 - t0,
                cpu_s=time.perf_counter() - t1)


# ---------------------------------------------------------------------------
# phases 9-12: the fake-quant gradient kernels and the guarded training path
# ---------------------------------------------------------------------------

def time_cold_ms(fn, args_list, iters: int = 20, warmup: int = 3,
                 queued: bool = False) -> float:
    """``time_ms`` (or, ``queued``, ``queued_ms``) cycling through argument
    tuples whose tensors together exceed the 50 MB L2, so each launch reads
    its input from device memory as the train step's gradient and the
    decode step's weights are read (the work that touched them last has
    moved on to other tensors)."""
    import torch
    n = len(args_list)
    for i in range(warmup):
        fn(*args_list[i % n])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(iters):
        fn(*args_list[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _qdq_input(torch, dev, gen, rows, f, bits, dtype):
    """A (rows, f) gradient-like tensor with the rounding cases planted: row
    0 reaches absmax qmax (a per-row scale of exactly 1) and holds exact x.5
    ties of both signs, row 1 is all zero, and rows 2-5 of column 2 hold
    x.5 values (ties under the per-channel scale of 1 phase 9 gives it)."""
    qmax = 2 ** (bits - 1) - 1
    x = torch.randn((rows, f), generator=gen, device=dev) * 0.02
    x[0, :8] = torch.tensor([qmax, 0.5, 1.5, 2.5, -2.5, -0.5, -3.5, 4.5],
                            device=dev)
    x[1] = 0.0
    x[2:6, 2] = torch.tensor([0.5, -1.5, 2.5, -4.5], device=dev)
    return x.to(dtype).contiguous()


def _yardstick_ms(torch, fn, x):
    """Time of a PyTorch fake-quantize call on ``x``, or on its float32
    copy where the call refuses bfloat16; (ms, dtype it ran at)."""
    try:
        fn(x)
        torch.cuda.synchronize()
        return time_ms(lambda: fn(x)), str(x.dtype).replace("torch.", "")
    except RuntimeError:
        xf = x.float()
        return time_ms(lambda: fn(xf)), "float32"


def check_qdq(torch, dev, gen, results):
    """Phase 9: ``qdq_row`` and ``qdq_scaled`` (per channel, (1, F), and per
    tensor, (1, 1)) bit for bit against their plain versions at the
    gradients' shapes, (8192, 768) and (8192, 3072), bfloat16 and float32,
    8 and 4 bits, with planted ties and an all-zero row; each timed with
    the L2 cold, queued (the kernel's time: ``ms``) and call by call (its
    wrapper's host dispatch included), beside its byte bound, its plain
    version and a PyTorch yardstick:
    ``torch.amax`` + ``fake_quantize_per_channel_affine`` (axis 0 for #1,
    axis 1 for the per-channel #2) and ``fake_quantize_per_tensor_affine``
    (per-tensor #2), which multiply by a reciprocal -- a time, not an
    oracle."""
    from repro_torch.core.quantizer import _div
    from repro_torch.kernels.qdq import (qdq_row, qdq_row_plain, qdq_scaled,
                                         qdq_scaled_plain)
    m = TRAIN_BATCH * TRAIN_SEQ
    rows = {"qdq_row": [], "qdq_scaled": []}
    for f in (768, 3072):
        for dtype in (torch.bfloat16, torch.float32):
            for bits in (8, 4):
                qmax = 2 ** (bits - 1) - 1
                x = _qdq_input(torch, dev, gen, m, f, bits, dtype)
                nbytes = 2 * x.numel() * x.element_size()
                copies = [(x,)] + [(x.clone(),) for _ in
                                   range(int(100e6 // nbytes) + 1)]
                dname = str(dtype).replace("torch.", "")
                zp_c = torch.zeros(f, dtype=torch.int32, device=dev)
                zp_r = torch.zeros(m, dtype=torch.int32, device=dev)
                xa = x.float().abs()
                s_chan = _div(xa.amax(dim=0, keepdim=True).clamp_min(1e-12),
                              float(qmax))
                s_chan[0, 2] = 1.0                # the planted ties
                s_tens = _div(xa.amax().clamp_min(1e-12),
                              float(qmax)).reshape(1, 1)
                cases = [
                    ("qdq_row", "per row", lambda a: qdq_row(a, bits),
                     lambda: qdq_row_plain(x, bits),
                     lambda t: torch.fake_quantize_per_channel_affine(
                         t, _div(t.float().abs().amax(dim=1).clamp_min(
                             1e-12), float(qmax)), zp_r, 0, -qmax - 1, qmax),
                     0),
                    ("qdq_scaled", "per channel",
                     lambda a: qdq_scaled(a, s_chan, bits),
                     lambda: qdq_scaled_plain(x, s_chan, bits),
                     lambda t: torch.fake_quantize_per_channel_affine(
                         t, s_chan.reshape(-1), zp_c, 1, -qmax - 1, qmax),
                     4 * f),
                    ("qdq_scaled", "per tensor",
                     lambda a: qdq_scaled(a, s_tens, bits),
                     lambda: qdq_scaled_plain(x, s_tens, bits),
                     lambda t: torch.fake_quantize_per_tensor_affine(
                         t, s_tens.reshape(()), zp_c[:1].reshape(()),
                         -qmax - 1, qmax),
                     4),
                ]
                for name, kind, kern, plain, lib_fn, extra in cases:
                    got, want = kern(x), plain()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    if not torch.equal(got, want):
                        fail(f"{name} {kind} ({m}, {f}) {dname} bits {bits} "
                             f"not bit-exact (max err {err})")
                    ms = time_cold_ms(kern, copies, queued=True)
                    call_ms = time_cold_ms(kern, copies)
                    plain_ms = time_ms(plain, iters=5)
                    lib, lib_dtype = _yardstick_ms(torch, lib_fn, x)
                    b, by = bound_ms(nbytes + extra, 7.0 * x.numel(),
                                     FP32_FLOPS)
                    rows[name].append(dict(
                        shape=f"({m},{f}) {dname} bits={bits} {kind}",
                        max_abs_err=err, ms=ms, call_ms=call_ms,
                        plain_ms=plain_ms,
                        bound_ms=b, bound_by=by, library_ms=lib,
                        library_dtype=lib_dtype))
                    print(f"{name} {kind:11s} ({m}, {f:4d}) {dname:8s} bits "
                          f"{bits}: bit-exact (tol 0), queued ms {ms:.4f}, "
                          f"call by call {call_ms:.4f}, plain_ms "
                          f"{plain_ms:.4f}, bound_ms {b:.5f} ({by}), "
                          f"library_ms(fake_quantize, {lib_dtype}) "
                          f"{lib:.4f}")
    # the JSON entry reports the shape with the most launches on the main
    # path: the bf16 gradients of q, k, v, o and down, F = 768 (60 of the
    # 72 a step), 8 bits; #2 per channel (g8c; g8n times alike)
    for name, line in (("qdq_row", 59), ("qdq_scaled", 79)):
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/qdq.cu",
            replaces=f"src/repro/kernels/qdq.py:{line}", tol=0.0,
            shapes=rows[name], **rows[name][0])
    bulk_sass_check(("qdq", "qdq_row_stream_kernel"))


def _step_recorder(torch, fn, log, kind):
    """``fn`` (a train step) wrapped to log, per call, its kind, host
    milliseconds to a device sync, ce, grad norm and the launches of every
    kernel."""
    from repro_torch import kernels

    def step(state, batch):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        new, met = fn(state, batch)
        ce = float(met["ce"])
        torch.cuda.synchronize()
        log.append(dict(kind=kind, ms=(time.perf_counter() - t0) * 1e3,
                        ce=ce, gn=float(met["grad_norm"]),
                        launches={k: v - before[k] for k, v in
                                  kernels.launch_counts().items()}))
        return new, met
    return step


def _expect(**nonzero):
    return {k: nonzero.get(k, 0) for k in KERNEL_NAMES}


def gpt2_train_cfg(**kw):
    """GPT-2 small as phases 7, 10, 11 and 14 train it: ``remat=False``
    pinned, so their launch gates (72 #3 a step) and their series of
    numbers keep the meaning they had before the port recomputed; their CE
    chunks are checkpointed all the same, as in the reference."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gpt2-small"), remat=False, **kw)


def train_fake(torch, dev, seed):
    """Phase 10: GPT-2 small at full width and depth, 8 x 1024 tokens a
    step, trained through the port's ``Trainer`` under the fake-quant
    recipes (the default ``fake_quant`` backend): ``paper_wag8`` (W8/A8/G8,
    the gradient per token through ``qdq_row``) for 10 steps -- ms per
    step, tokens/s, peak memory, and the idle share of one profiled step
    -- then one step each of ``w8c,a8t,g8n`` and ``w8c,a8t,g8c``
    (``qdq_scaled`` per tensor and per channel).  Every step must launch
    its qdq kernel exactly 72 times and no other kernel, with finite ce
    and grad norm.  Returns the launch counts of the three runs."""
    from repro_torch import kernels
    from repro_torch.core.qconfig import Granularity, get_recipe
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (LoopConfig, Trainer, init_train_state,
                                   make_train_step, train_path_summary)
    cfg = gpt2_train_cfg()
    model = build_model(cfg)
    linears = 6 * cfg.n_layers
    kept = None
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i, name in enumerate(FAKE_RECIPES):
        recipe = get_recipe(name)
        steps = TRAIN_STEPS if i == 0 else 1
        opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=steps)
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed), recipe,
            opt, device=dev)
        step_fn = make_train_step(model, recipe, opt)
        log = []
        trainer = Trainer(_step_recorder(torch, step_fn, log, "primary"),
                          None, state,
                          Loader(SyntheticCorpus(cfg.vocab_size, seed=7),
                                 cfg, batch_size=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ),
                          loop_cfg=LoopConfig(total_steps=steps,
                                              ckpt_every=10 ** 9,
                                              log_every=1))
        torch.cuda.reset_peak_memory_stats()
        trainer.run()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kern = ("qdq_row" if recipe.grads.granularity is Granularity.PER_TOKEN
                else "qdq_scaled")
        want = _expect(**{kern: linears})
        print(f"train_fake: {name} ({recipe.describe()}), {cfg.n_layers}L "
              f"d={cfg.d_model}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; "
              f"train-path: {train_path_summary(recipe, cfg.n_layers, opt, device=dev)}")
        for j, r in enumerate(log):
            print(f"train_fake: {name} step {j + 1:2d} ce {r['ce']:.4f} "
                  f"grad_norm {r['gn']:.4f} {r['ms']:.1f} ms")
            if not (math.isfinite(r["ce"]) and math.isfinite(r["gn"])):
                fail(f"train_fake {name} step {j + 1}: ce {r['ce']}, grad "
                     f"norm {r['gn']}")
            if r["launches"] != want:
                fail(f"train_fake {name} step {j + 1}: launches "
                     f"{r['launches']}, expected {want}")
        if i == 0:
            steady = [r["ms"] for r in log[1:]]
            mean = sum(steady) / len(steady)
            tok = TRAIN_BATCH * TRAIN_SEQ
            print(f"train_fake: {name} {steps} steps, step 1 "
                  f"{log[0]['ms']:.1f} ms, steps 2-{steps} mean {mean:.1f} "
                  f"ms (min {min(steady):.1f}, max {max(steady):.1f}), "
                  f"{tok / mean * 1e3:.0f} tokens/s, peak memory "
                  f"{peak:.2f} GiB")
            kept = (step_fn, trainer.state)
    counts = kernels.launch_counts()
    print(f"train_fake: launch counts {counts}")
    batch = torch.from_numpy(Loader(SyntheticCorpus(cfg.vocab_size, seed=7),
                                    cfg, batch_size=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ).peek(TRAIN_STEPS)
                             ["tokens"]).to(dev)
    profile_train_step(torch, kept[0], kept[1], batch)
    return counts


def recording(sentinel, log):
    """``sentinel`` with its verdicts appended to ``log`` as (loop step,
    verdict value) pairs."""
    observe = sentinel.observe

    def wrapped(step, metrics):
        v = observe(step, metrics)
        log.append((step, v.value))
        return v
    sentinel.observe = wrapped
    return sentinel


def train_guarded(torch, dev, seed):
    """Phase 11: the guarded path at full width -- GPT-2 small, 8 x 1024
    tokens a step, ``TRAIN_POLICY`` on the int8 kernels under the stability
    sentinel (``LADDER_SENTINEL``), async checkpoints every 3 steps into
    ``build/chip_smoke_ckpt`` (keep 2; the directory is removed at the
    end), the fault plan ``nan_grad@5``, 12 steps.  The ladder must equal
    ``LADDER_EXPECT`` (pinned on the CPU against the JAX Trainer); primary
    steps launch int8_matmul / nt / tn / AdamW 72 / 72 / 72 / 1 times and
    no qdq kernel, fallback steps (``fallback_policy``: fake quant, G8 per
    token) ``qdq_row`` 72 times, AdamW once and no int8 kernel; the run
    ends at ``opt.step == 12`` with finite params.  Returns the launch
    counts of the run."""
    import shutil
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.qpolicy import fallback_policy
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.train import (FaultPlan, LoopConfig, SentinelConfig,
                                   StabilitySentinel, Trainer,
                                   init_train_state, make_train_step)
    ckdir = REPO / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        cfg = gpt2_train_cfg()
        model = build_model(cfg)
        linears = 6 * cfg.n_layers
        opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=LADDER_STEPS,
                        state_storage="int")
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed),
            TRAIN_POLICY, opt, device=dev)
        faults = FaultPlan.parse(LADDER_FAULT)
        log, verdicts = [], []
        primary = _step_recorder(torch, make_train_step(
            model, TRAIN_POLICY, opt, faults=faults, health=True), log,
            "primary")
        fallback = _step_recorder(torch, make_train_step(
            model, fallback_policy(TRAIN_POLICY), opt, health=True), log,
            "fallback")
        mgr = CheckpointManager(str(ckdir), keep_n=2, async_write=True)
        trainer = Trainer(
            primary, None, state,
            Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                   batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ),
            ckpt=mgr,
            loop_cfg=LoopConfig(total_steps=LADDER_STEPS,
                                ckpt_every=LADDER_CKPT_EVERY, log_every=1),
            sentinel=recording(StabilitySentinel(SentinelConfig(
                **LADDER_SENTINEL)), verdicts),
            fallback_step=fallback, faults=faults)
        gc.collect()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        ck_bytes = sum(p.stat().st_size for p in ckdir.rglob("*")
                       if p.is_file())
        kept = mgr.all_steps()
        summary = trainer.resilience_summary()
        rec = ladder_record(summary, trainer.history, verdicts)
        for (st, v), r in zip(verdicts, log):
            print(f"train_guarded: loop step {st:2d} {r['kind']:8s} ce "
                  f"{r['ce']:.4f} grad_norm {r['gn']:.4f} {r['ms']:.1f} ms "
                  f"-> {v}")
        print(f"train_guarded: {len(log)} steps run in {wall:.1f} s "
              f"(checkpoints and rollback included); checkpoints kept "
              f"{kept}, {ck_bytes / 2 ** 30:.2f} GiB on disk; resilience "
              f"{summary}")
        print(f"train_guarded: ladder {json.dumps(rec)}")
        print(f"train_guarded: launch counts {counts}")
        if rec != LADDER_EXPECT:
            fail(f"phase 11 ladder {rec} != LADDER_EXPECT {LADDER_EXPECT}")
        want = {"primary": _expect(int8_matmul=linears, int8_matmul_nt=linears,
                                   int8_matmul_tn=linears,
                                   fused_adamw_leaves=1),
                "fallback": _expect(qdq_row=linears, fused_adamw_leaves=1)}
        for i, r in enumerate(log):
            if r["launches"] != want[r["kind"]]:
                fail(f"phase 11 call {i} ({r['kind']}): launches "
                     f"{r['launches']}, expected {want[r['kind']]}")
        if int(trainer.state.opt.step) != LADDER_STEPS:
            fail(f"phase 11 ended at opt.step {int(trainer.state.opt.step)}")
        if not all(bool(torch.isfinite(p).all())
                   for p in tree_flatten(trainer.state.params)[0]):
            fail("phase 11 ended with non-finite params")
        return counts
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        print(f"train_guarded: checkpoint directory removed: "
              f"{not ckdir.exists()}")


def train_resume(torch, dev, seed):
    """Phase 11b: preemption and resume at full width.  ``TRAIN_POLICY``,
    6 steps uninterrupted; then the same run with ``sigterm_run@2`` (the
    SIGTERM handler saves the checkpoint of step 3 and stops), and a third
    run from other weights that resumes from it.  The resumed ce of steps
    4-6, its params and its optimizer state (int8 moments, step) must be
    bit-identical to the uninterrupted run's."""
    import shutil
    import signal
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.train import (FaultPlan, LoopConfig, Trainer,
                                   init_train_state, make_train_step)
    cfg = gpt2_train_cfg()
    model = build_model(cfg)
    total = 6
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=total,
                    state_storage="int")
    step_fn = make_train_step(model, TRAIN_POLICY, opt)
    lcfg = LoopConfig(total_steps=total, ckpt_every=10 ** 9, log_every=1)

    def trainer(s, **kw):
        return Trainer(step_fn, None, init_train_state(
            model, torch.Generator(device=dev).manual_seed(s), TRAIN_POLICY,
            opt, device=dev), Loader(SyntheticCorpus(cfg.vocab_size, seed=7),
                                     cfg, batch_size=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ), loop_cfg=lcfg, **kw)

    def leaves(st):
        return (tree_flatten(st.params)[0] + [st.opt.step]
                + [t for m in (st.opt.m1, st.opt.m2)
                   for leaf in tree_flatten(m)[0]
                   for t in (leaf if isinstance(leaf, tuple) else (leaf,))])

    ckdir = REPO / "build" / "chip_smoke_resume"
    shutil.rmtree(ckdir, ignore_errors=True)
    old = signal.getsignal(signal.SIGTERM)
    try:
        ref = trainer(seed)
        ref.run()
        mgr = CheckpointManager(str(ckdir), async_write=True)
        faults = FaultPlan.parse("sigterm_run@2")
        t1 = trainer(seed, ckpt=mgr, faults=faults)
        t1.install_preemption_handler()
        t1.run()
        saved = mgr.all_steps()
        t2 = trainer(seed + 1, ckpt=CheckpointManager(str(ckdir)))
        at = t2.maybe_resume()
        t2.run()
    finally:
        signal.signal(signal.SIGTERM, old)
        shutil.rmtree(ckdir, ignore_errors=True)
    ref_tail = [r["ce"] for r in ref.history if r["step"] > at]
    got_tail = [r["ce"] for r in t2.history if r["step"] > at]
    same = all(torch.equal(a, b) for a, b in zip(leaves(ref.state),
                                                 leaves(t2.state)))
    print(f"train_resume: preempted {t1._preempted} after loop step 2, "
          f"checkpoints {saved}, resumed at {at}; ce tail {got_tail} vs "
          f"uninterrupted {ref_tail}; params and optimizer state "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not (t1._preempted and saved == [3] and at == 3
            and got_tail == ref_tail and len(got_tail) == total - 3 and same):
        fail("phase 11b: the resumed run is not bit-identical to the "
             "uninterrupted one")


# phase 12: limits of the card against the CPU for one paper_wag8 step on
# gpt2-mini, named like TRAIN_LIMITS.  Each is the geometric mean, to two
# digits, of the sound runs' largest reading (A) and the smallest reading
# of a control that the comparison must tell apart (C: the card at the
# bf16 carrier), over seeds 0-2 as recorded in PERF.md: |d ce| 7.5e-5 /
# 2.0e-4, grads rel L2 3.8e-3 / 1.95e-2, gradient sign differs on 2.4e-3
# / 8.7e-3 of the elements, updates rel L2 9.1e-2 / 0.187 and 6.5e-3 /
# 1.59e-2 where the sign agrees.
FAKE_LIMITS = {"ce": 1.2e-4, "grads": 8.6e-3, "sign_flips": 4.5e-3,
               "updates_sign": 1.0e-2, "updates": 0.13}


def _step_distance(torch, got, ref):
    """How far one train step's result ``got`` lies from ``ref``, keyed
    like ``FAKE_LIMITS``: |d ce|, the gradients' relative L2 distance, the
    share of elements whose gradient sign differs, the updates' relative
    L2 distance over all elements and over those whose sign agrees."""
    upd = lambda r: [a - b for a, b in zip(r["p"], r["p0"])]
    flips, pays, u_sign = _update_split(torch, got, ref)
    return {"ce": abs(got["loss"] - ref["loss"]),
            "grads": _rel_l2(torch, got["grads"], ref["grads"]),
            "sign_flips": flips, "updates_sign": u_sign,
            "updates": _rel_l2(torch, upd(got), upd(ref)), "payloads": pays}


def train_fake_card_vs_cpu(torch, dev, seed):
    """Phase 12: one ``paper_wag8`` train step of gpt2-mini (float32
    carrier, 4 x 128 tokens, fp moments) from ``true_fan_in`` weights
    (seed + 2), as phase 8 does for the int8 recipe.  A: the card (the qdq
    kernels) against the CPU (their plain versions), each distance of
    ``_step_distance`` within ``FAKE_LIMITS``.  B: the card again with
    ``qdq_row`` and ``qdq_scaled`` swapped for their plain versions: every
    gradient bit-identical (control: the card twice).  C: the control of
    A's limits, the same step on the card at the bf16 carrier against the
    same CPU step: every distance above its limit, so A would see a step
    that lost the float32 carrier's precision."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qconfig import get_recipe
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    cfg = dataclasses.replace(get_smoke_config("gpt2-small"), dtype="float32")
    model = build_model(cfg)
    params = true_fan_in(model.init_params(
        torch.Generator().manual_seed(seed + 2), device="cpu"), cfg)
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=4, seq_len=128))
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    policy = as_policy(get_recipe("paper_wag8"))

    def run(device, swap=(), m=model):
        return one_train_step(torch, m, policy, params, toks, opt,
                              device, swap=swap)

    lim = FAKE_LIMITS
    names = {"ce": "|d ce|", "grads": "grads rel L2",
             "sign_flips": "gradient sign differs on",
             "updates": "updates rel L2",
             "updates_sign": "updates rel L2 where the sign agrees"}
    show = lambda d: ", ".join(f"{names[k]} {d[k]:.3e} (limit {lim[k]:.1e})"
                               for k in names)
    cpu, card = run("cpu"), run(dev)
    dist = _step_distance(torch, card, cpu)
    print(f"train_fake card vs cpu A (gpt2-mini, float32 carrier, 4 x 128 "
          f"tokens, paper_wag8): ce {card['loss']:.6f} vs {cpu['loss']:.6f}, "
          f"{show(dist)}")
    ok = all(dist[k] <= lim[k] for k in lim)
    control = run(dev)
    swapped = run(dev, swap=QDQ_KERNELS)
    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(a["grads"], b["grads"]))
    ctrl_same, swap_same = same(card, control), same(card, swapped)
    print(f"train_fake card vs card B: grads with the plain qdq in the "
          f"kernels' place {'bit-identical' if swap_same else 'DIFFER'} "
          f"(control, the card twice: "
          f"{'bit-identical' if ctrl_same else 'DIFFER'}; tol 0)")
    low = run(dev, m=build_model(dataclasses.replace(cfg, dtype="bfloat16")))
    low_dist = _step_distance(torch, low, cpu)
    low_ok = all(low_dist[k] > lim[k] for k in lim)
    print(f"train_fake control C, the card at the bf16 carrier vs cpu: "
          f"ce {low['loss']:.6f}, {show(low_dist)}: every distance above its "
          f"limit {'yes' if low_ok else 'NO'}")
    if not (ok and ctrl_same and swap_same):
        fail("phase 12: paper_wag8 step card vs CPU / card vs card out of "
             "limits")
    if not low_ok:
        fail("phase 12: the bf16-carrier control lies within FAKE_LIMITS, "
             "so the limits cannot tell it from a sound step")


# ---------------------------------------------------------------------------
# phases 13-15: the fp flash kernels (#7-#10) and the flash_pallas paths
# ---------------------------------------------------------------------------

def _flash_all(fa, q, k, v, do, causal, off):
    """#8's (o, lse), then #9's (dk, dv) and #10's dq from them with delta =
    sum(dO * o), summed in float64 and rounded to fp32; returns (o, lse, dq,
    dk, dv, delta).  Under the causal mask at q_offset 0 query row 0 sees
    key 0 alone, so o_0 = v_0 and dp_00 - delta_0 is zero in exact
    arithmetic: with delta summed in fp32, dq's row 0 would be the
    difference of two fp32 orders of the same 64 products (rounding noise,
    more than one bf16 step apart between any two orders); the float64 sum
    gives delta its exact value, as the plain backward's float64 sums give
    dp theirs."""
    kw = dict(causal=causal, q_offset=off)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    delta = (do.double() * o.double()).sum(-1).float()
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return o, lse, dq, dk, dv, delta


def _flash_plain(fa, q, k, v, do, lse, delta, causal, off, **sums):
    """The plain versions on the kernels' inputs: #8's on q, k, v, #9's and
    #10's on the lse and delta the kernels read, their products summed in
    float64 (their default) or ``sum_dtype=``; returns (o, lse, dq, dk,
    dv)."""
    kw = dict(causal=causal, q_offset=off)
    o, lse_p = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                               **kw, **sums)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw,
                                         **sums)
    return o, lse_p, dq, dk, dv


def _bf16_distance(torch, got, want):
    """(relative L2 distance, share of elements more than one bf16 step of
    ``want`` apart) of two bfloat16 tensors; a zero in ``want`` has the
    step of 0.5-1."""
    g, w = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    over = ((g - w).abs() > step).float().mean().item()
    return _rel_l2(torch, [got], [want]), over


def _visible_pairs(sq, skv, causal, off):
    """(query, key) pairs the kernels compute: the causally visible ones."""
    if not causal:
        return sq * skv
    return sum(min(skv, off + i + 1) for i in range(sq))


def _flash_case(torch, fa, q, k, v, do, causal, off):
    """One phase-13 case: the kernels against their plain versions on the
    same inputs.  Returns the printed reading and whether it passed."""
    dname = str(q.dtype).replace("torch.", "")
    got = _flash_all(fa, q, k, v, do, causal, off)
    want = _flash_plain(fa, q, k, v, do, got[1], got[5], causal, off)
    again = _flash_all(fa, q, k, v, do, causal, off)
    o7 = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    diff = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got[:5], want)]
    same7 = torch.equal(o7, got[0])
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (diff[0] <= FLASH_TOL[dname] and diff[1] <= FLASH_LSE_TOL
          and same7 and repeat)
    if q.dtype == torch.float32:
        rel = [_rel_l2(torch, [g], [w]) for g, w in zip(got[2:5], want[2:])]
        ok &= max(rel) <= FLASH_GRAD_TOL
        text = (f"dq/dk/dv rel L2 {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e} "
                f"(tol {FLASH_GRAD_TOL:.0e})")
    else:
        # o, dq, dk, dv; then the controls, each one rounding of p or ds
        # moved: the plain forward with p left unrounded, with p rounded
        # against the row's final max (the reference's _ref_attend, one
        # tile), dv from p rounded to the carrier, and dk and dq from ds
        # rounded to the carrier (the products summed in float64, as the
        # plain backward's)
        dist = [_bf16_distance(torch, g, w)
                for g, w in zip(got[:1] + got[2:5], want[:1] + want[2:])]
        kw = dict(causal=causal, q_offset=off)
        ctrl_o = fa.flash_attention_fwd_lse_plain(
            q.float(), k.float(), v.float(), **kw)[0].to(q.dtype)
        row_o = fa.flash_attention_fwd_lse_plain(q, k, v, block_k=k.shape[1],
                                                 **kw)[0]
        p, ds = fa._bwd_plain(q, k, v, do, got[1], got[5], causal, off)
        f64 = torch.float64
        ctrl_dv = fa._product("bqk,bqd->bkd", p.to(q.dtype), do,
                              f64).to(q.dtype)
        del p
        ds = ds.to(q.dtype)
        ctrl_dk = fa._product("bqk,bqd->bkd", ds, q, f64).to(q.dtype)
        ctrl_dq = fa._product("bqk,bkd->bqd", ds, k, f64).to(q.dtype)
        del ds
        ctrl = [_bf16_distance(torch, c, w) for c, w in
                ((ctrl_o, want[0]), (row_o, want[0]), (ctrl_dv, want[4]),
                 (ctrl_dk, want[3]), (ctrl_dq, want[2]))]
        # readings, not gates: the plain forward with its scores summed in
        # fp32 (PR 15's plain version), and the plain backward with its
        # products summed in fp32, against the float64-summed ones
        f32 = _bf16_distance(torch, fa.flash_attention_fwd_lse_plain(
            q, k, v, score_dtype=torch.float32, **kw)[0], want[0])
        bwd32 = _flash_plain(fa, q, k, v, do, got[1], got[5], causal, off,
                             sum_dtype=torch.float32)[2:]
        f32_bwd = [_bf16_distance(torch, g, w) for g, w in zip(bwd32,
                                                                want[2:])]
        del bwd32
        lim = FLASH_BF16
        within = lambda d: d[0] <= lim["rel_l2"] and d[1] <= lim["over_ulp"]
        outside = lambda d: d[0] > lim["rel_l2"] and d[1] > lim["over_ulp"]
        ok &= all(within(d) for d in dist) and all(outside(d) for d in ctrl)
        pair = lambda ds_: ", ".join(f"{c[0]:.2e}, {c[1]:.2e}" for c in ds_)
        text = ("o/dq/dk/dv rel L2 " + "/".join(f"{d[0]:.2e}" for d in dist)
                + f" (limit {lim['rel_l2']:.0e}), over one bf16 step "
                + "/".join(f"{d[1]:.2e}" for d in dist)
                + f" (limit {lim['over_ulp']:.0e}); controls (rel L2, over "
                f"one step) p unrounded {pair(ctrl[:1])}, p against the "
                f"final max {pair(ctrl[1:2])}, dv with p rounded "
                f"{pair(ctrl[2:3])}, dk / dq with ds rounded "
                f"{pair(ctrl[3:])}: all above both limits "
                + ("yes" if all(outside(d) for d in ctrl) else "NO")
                + f"; fp32-summed plain scores {f32[0]:.2e}, {f32[1]:.2e}, "
                f"fp32-summed plain dq/dk/dv {pair(f32_bwd)}")
    reading = (f"o max err {diff[0]:.2e} (tol {FLASH_TOL[dname]:.0e}), lse "
               f"{diff[1]:.2e} (tol {FLASH_LSE_TOL:.0e}), {text}; max abs "
               f"dq/dk/dv {diff[2]:.2e}/{diff[3]:.2e}/{diff[4]:.2e}; #7 == #8 "
               f"{'bit for bit' if same7 else 'DIFFERS'}, second launch "
               f"{'bit-identical' if repeat else 'DIFFERS'}")
    return reading, ok, diff


def check_flash(torch, dev, gen, results):
    """Phase 13: the fp flash kernels against their plain versions on the
    card, on the same inputs (``_flash_case``), at the training shape and
    at ``FLASH_SWEEP``, float32 and bfloat16, unit-normal inputs: #8's
    output and LSE, #9's dK/dV and #10's dQ within ``FLASH_TOL`` /
    ``FLASH_LSE_TOL`` / ``FLASH_GRAD_TOL`` (float32) / ``FLASH_BF16``
    (bfloat16, with its two controls outside); #7's output equal to #8's
    bit for bit; a second launch of each kernel equal to its first bit for
    bit; a NaN planted in q reaching o, the LSE and the gradients.  Each
    kernel timed at the training shape (bf16) beside its plain version,
    its bound and SDPA: its forward for #7/#8, its backward for #9 and #10
    together (a yardstick, unused by the port); #9, #10 and SDPA's backward
    also with the card's queue full (``queued_ms``).  The bound counts the
    least the tensor cores need: at hd = 64 and the bf16 carrier q / 8, k,
    v, dO and the forward's rounded p are bf16 values, so the score
    products, the forward's P.V and the backward's dO.V are each one
    bf16-exact product; each product with an fp32 operand (p^T dO, ds^T q,
    ds k) is three bf16-exact products (the operand split into three bf16
    terms), all at 989 TFLOP/s.  Last, the SASS checks
    (``flash_sass_check``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    bh, s, hd = TRAIN_BATCH * 12, TRAIN_SEQ, 64
    cases = (("train", bh, s, s, hd, True, 0),) + FLASH_SWEEP
    errs = {}
    ok = True
    for label, b_, sq, skv, d, causal, off in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                           .to(dt) for shape in ((b_, sq, d), (b_, skv, d),
                                                 (b_, skv, d), (b_, sq, d)))
            reading, case_ok, diff = _flash_case(torch, fa, q, k, v, do,
                                                 causal, off)
            ok &= case_ok
            print(f"flash {label:9s} BH={b_:3d} Sq={sq:4d} Skv={skv:4d} "
                  f"hd={d:3d} {'causal' if causal else 'full':6s} "
                  f"q_offset={off:3d} {str(dt)[6:]:8s}: {reading}"
                  f"{'' if case_ok else '  <-- FAIL'}")
            # the forward's float32 errors, as recorded since PR 15; the
            # backward's at bf16, the carrier of the main path's new kernels
            if label == "train" and dt == torch.float32:
                errs.update({"flash_attention_fwd": diff[0],
                             "flash_attention_fwd_lse": max(diff[0],
                                                            diff[1])})
            if label == "train" and dt == torch.bfloat16:
                errs.update({"flash_attention_bwd_dkdv": max(diff[3],
                                                             diff[4]),
                             "flash_attention_bwd_dq": diff[2]})
            del q, k, v, do
    # a NaN in q row 70 of head 1 reaches its o and LSE rows, its dq row and
    # the dk / dv rows it attends to; head 0 stays finite -- at hd 64 and at
    # the wide backward's two instances (hd 160 and 256)
    for d in FLASH_NAN_HEAD_DIMS:
        q, k, v, do = (torch.randn((2, 256, d), generator=gen, device=dev)
                       .bfloat16() for _ in range(4))
        q[1, 70, 5] = float("nan")
        o, lse, dq, dk, dv, _ = _flash_all(fa, q, k, v, do, True, 0)
        nan_ok = (bool(o[1, 70].isnan().all()) and bool(lse[1, 70].isnan())
                  and bool(dq[1, 70].isnan().all())
                  and bool(dk[1, :71].isnan().all())
                  and bool(dv[1, :71].isnan().all())
                  and all(bool(t[0].isfinite().all())
                          for t in (o, dq, dk, dv)))
        print(f"flash NaN planted in q[1, 70] at hd {d}: o, lse, dq row and "
              f"dk/dv rows 0-70 "
              f"{'NaN, head 0 finite' if nan_ok else 'NOT as expected'}")
        ok &= nan_ok
    # the cross row's case: non-causal, 256 query rows over 64 keys -- row
    # 70 of head 1 attends to every key, so all of its dk / dv rows are NaN
    q, do = (torch.randn((2, 256, 64), generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((2, 64, 64), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    q[1, 70, 5] = float("nan")
    o, lse, dq, dk, dv, _ = _flash_all(fa, q, k, v, do, False, 0)
    nan_ok = (bool(o[1, 70].isnan().all()) and bool(lse[1, 70].isnan())
              and bool(dq[1, 70].isnan().all()) and bool(dk[1].isnan().all())
              and bool(dv[1].isnan().all())
              and int(o[1].isnan().any(-1).sum()) == 1
              and all(bool(t[0].isfinite().all()) for t in (o, dq, dk, dv)))
    print(f"flash NaN planted in q[1, 70], non-causal, Sq 256 > Skv 64 at hd "
          f"64: o, lse and dq row 70, every dk/dv row of head 1 "
          f"{'NaN, the other o rows and head 0 finite' if nan_ok else 'NOT as expected'}")
    ok &= nan_ok
    if not ok:
        fail("phase 13: a flash kernel disagrees with its plain version")

    # timing at the training shape, bf16
    q, k, v, do = (torch.randn((bh, s, hd), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    q4, k4, v4, do4 = (t.view(TRAIN_BATCH, 12, s, hd) for t in (q, k, v, do))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_call = lambda: torch.autograd.grad(o4, leaves, do4,
                                            retain_graph=True)
    sdpa_bwd, sdpa_bwd_q = time_ms(sdpa_call), queued_ms(sdpa_call)
    pairs = _visible_pairs(s, s, True, 0) * bh
    tens, rows = bh * s * hd * 2, bh * s * 4     # bf16 tensor, fp32 rows
    mm = 2 * hd * pairs                          # one product over the pairs
    plan = (   # name, site line, kernel, plain, bytes, bf16-exact FLOPs
        ("flash_attention_fwd", 116, lambda: fa.flash_attention_fwd(q, k, v),
         lambda: fa.flash_attention_fwd_plain(q, k, v), 4 * tens, 2 * mm,
         sdpa_fwd, None, "SDPA forward"),
        ("flash_attention_fwd_lse", 275,
         lambda: fa.flash_attention_fwd_lse(q, k, v),
         lambda: fa.flash_attention_fwd_lse_plain(q, k, v), 4 * tens + rows,
         2 * mm, sdpa_fwd, None, "SDPA forward"),
        # q.k, dO.v, and three terms each of p^T dO and ds^T q
        ("flash_attention_bwd_dkdv", 344,
         lambda: fa.flash_attention_bwd_dkdv(*bwd),
         lambda: fa.flash_attention_bwd_dkdv_plain(*bwd),
         6 * tens + 2 * rows, 8 * mm, sdpa_bwd, sdpa_bwd_q,
         "SDPA backward, dq+dk+dv together"),
        # q.k, dO.v, and three terms of ds k
        ("flash_attention_bwd_dq", 369,
         lambda: fa.flash_attention_bwd_dq(*bwd),
         lambda: fa.flash_attention_bwd_dq_plain(*bwd),
         5 * tens + 2 * rows, 5 * mm, sdpa_bwd, sdpa_bwd_q,
         "SDPA backward, dq+dk+dv together"))
    for name, line, kern, plain, nbytes, f16, lib, lib_q, lib_what in plan:
        ms = time_ms(kern)
        ms_q = queued_ms(kern) if lib_q is not None else None
        plain_ms = time_ms(plain, iters=3, warmup=1)
        bd, by = bound_ms(nbytes, f16, BF16_FLOPS)
        queued = ("" if ms_q is None else
                  f" (queued {ms_q:.4f}; library queued {lib_q:.4f})")
        print(f"{name} BH={bh} S={s} hd={hd} causal bf16: ms {ms:.4f}, "
              f"plain_ms {plain_ms:.4f}, bound_ms {bd:.5f} ({by}; "
              f"{f16 / 1e9:.1f} GFLOP bf16-exact at 989 TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB), {ms / bd:.1f}x the bound, "
              f"library_ms({lib_what}) {lib:.4f}{queued}")
        fwd = name in ("flash_attention_fwd", "flash_attention_fwd_lse")
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/"
            + ("flash_fwd_sm90.cu" if fwd else "flash_bwd_sm90.cu"),
            replaces=f"src/repro/kernels/flash_attn.py:{line}",
            tol=FLASH_TOL["float32" if fwd else "bfloat16"],
            shape=f"BH={bh},S={s},hd={hd},causal", max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by,
            library_ms=lib)
        if ms_q is not None:
            results[name].update(queued_ms=ms_q, library_queued_ms=lib_q)
    del q, k, v, do, o, lse, delta, bwd, q4, k4, v4, do4, leaves, o4

    # #8, #9 and #10 at hd 128 (the llama slice's head dim), BH 16, S 512,
    # causal, bf16
    b2, s2, d2 = 16, 512, 128
    q, k, v, do = (torch.randn((b2, s2, d2), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    bwd = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    q4, k4, v4, do4 = (t.view(1, b2, s2, d2) for t in (q, k, v, do))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True))
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = queued_ms(lambda: torch.autograd.grad(o4, leaves, do4,
                                                     retain_graph=True))
    mm2 = 2 * d2 * _visible_pairs(s2, s2, True, 0) * b2
    tens2, rows2 = b2 * s2 * d2 * 2, b2 * s2 * 4
    for name, fn, nbytes, ops, lib, lib_what, timer in (
            ("flash_attention_fwd_lse",
             lambda: fa.flash_attention_fwd_lse(q, k, v), 4 * tens2 + rows2,
             2 * mm2, sdpa, "SDPA forward", time_ms),
            ("flash_attention_bwd_dkdv",
             lambda: fa.flash_attention_bwd_dkdv(*bwd),
             6 * tens2 + 2 * rows2, 8 * mm2, sdpa_bwd,
             "SDPA backward, queued", queued_ms),
            ("flash_attention_bwd_dq", lambda: fa.flash_attention_bwd_dq(*bwd),
             5 * tens2 + 2 * rows2, 5 * mm2, sdpa_bwd,
             "SDPA backward, queued", queued_ms)):
        ms = timer(fn)
        bd, by = bound_ms(nbytes, ops, BF16_FLOPS)
        print(f"{name} BH={b2} S={s2} hd={d2} causal bf16: ms {ms:.4f}"
              f"{' (queued)' if timer is queued_ms else ''}, bound_ms "
              f"{bd:.5f} ({by}), {ms / bd:.1f}x the bound, "
              f"library_ms({lib_what}) {lib:.4f}")
        results[name]["hd128"] = dict(
            shape=f"BH={b2},S={s2},hd={d2},causal", ms=ms, bound_ms=bd,
            bound_by=by, library_ms=lib)
    del q, k, v, do, o, lse, bwd, q4, k4, v4, do4, leaves, o4
    flash_sass_check()


def _cuobjdump() -> str:
    """The toolkit's cuobjdump beside nvcc, else the copy Triton ships."""
    import importlib.util
    from repro_torch.kernels import _build
    cand = Path(_build.nvcc_path()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cand = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                / "cuobjdump")
        if cand.exists():
            return str(cand)
    fail("no cuobjdump beside nvcc or in Triton's package (the SASS checks "
         "of phases 6 and 13)")


def sass_counts(lib: str, mnemonic: str) -> dict:
    """Instructions whose opcode starts with ``mnemonic`` in each kernel of
    the built library ``csrc/<lib>.cu`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and any(tok.startswith(mnemonic)
                                    for tok in line.split()):
            counts[fn] += 1
    return counts


#: the SASS opcode of a 1-D bulk copy (``cp.async.bulk``) on sm_90a
BULK_SASS = "UBLKCP"


def bulk_sass_check(*libs) -> None:
    """Phases 6b and 9: the streaming kernels read by 1-D bulk copies --
    for each (library, kernel name) the ``BULK_SASS`` instructions of every
    instance of the kernel in the built library's SASS; fail if one has
    none."""
    for lib, kern in libs:
        counts = {k: v for k, v in sass_counts(lib, BULK_SASS).items()
                  if kern in k}
        print(f"{lib} SASS: {sum(counts.values())} {BULK_SASS} instructions "
              f"over {len(counts)} {kern} instances: "
              f"{sorted(counts.values())}")
        if not counts or not all(counts.values()):
            fail(f"a {kern} instance of {lib} has no {BULK_SASS}: {counts}")


def flash_sass_check() -> None:
    """Phase 13: the bf16 flash kernels run on the tensor cores -- the
    forward's (``flash_fwd_sm90.cu``, every head-dim template with and
    without the LSE store) and the backward's (``flash_bwd_sm90.cu`` and
    ``flash_bwd_sm90_wide.cu``, dK/dV and dQ at each head-dim template):
    count the ``HGMMA`` instructions of each in the built library's SASS,
    and fail if any kernel has none."""
    for lib in ("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd_sm90_wide"):
        counts = sass_counts(lib, "HGMMA")
        print(f"{lib} SASS: {sum(counts.values())} HGMMA instructions over "
              f"{len(counts)} kernels (each "
              f"{min(counts.values(), default=0)}-"
              f"{max(counts.values(), default=0)})")
        if not counts or min(counts.values()) == 0:
            fail(f"phase 13: a bf16 flash kernel of {lib} has no HGMMA: "
                 f"{counts}")


def serve_flash(torch, dev, seed):
    """Phase 14b: the dense engine on GPT-2 small with
    ``attention_impl="flash_pallas"`` and an fp KV cache
    (``FLASH_SERVE_POLICY``: W8A8 linears, no ``kv_cache`` role): the first
    ``FLASH_SERVE_REQUESTS`` of phase 4's prompts, ``FLASH_SERVE_NEW`` new
    tokens each.  Every request answered to length; each prefill launch
    runs #7 once per layer (no gradient is wanted, so the forward without
    the LSE), #8-#10 never; decode steps attend through ``_attend``.
    Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.infer import Engine, Request
    from repro_torch.models import build_model
    cfg, _, params = serve_model(torch, dev, seed)
    cfg = dataclasses.replace(cfg, attention_impl="flash_pallas")
    model = build_model(cfg)
    eng = Engine(model, params, FLASH_SERVE_POLICY, max_slots=SERVE_SLOTS,
                 max_seq=SERVE_SEQ, device=dev, seed=seed)
    prompts = serve_prompts(cfg, seed)[:FLASH_SERVE_REQUESTS]
    ids = [eng.submit(Request(tokens=p, max_new_tokens=FLASH_SERVE_NEW))
           for p in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats
    eng.scheduler.stop()
    healthy(eng, "phase 14b")
    if sorted(r.request_id for r in out) != sorted(ids):
        fail("phase 14b: the flash engine did not answer every request")
    for r in out:
        if (len(r.tokens) != FLASH_SERVE_NEW or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"phase 14b request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    want = _expect(int8_matmul=6 * cfg.n_layers * (st["prefill_calls"]
                                                   + st["decode_steps"]),
                   flash_attention_fwd=cfg.n_layers * st["prefill_calls"])
    print(f"serve_flash: {eng.path_summary()}, attention flash_pallas, "
          f"{len(out)} requests (prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens), {FLASH_SERVE_NEW} new tokens "
          f"each, in {wall:.3f} s; prefill {st['prefill_calls']} launches "
          f"{st['prefill_s'] * 1e3:.1f} ms, decode {st['decode_steps']} steps "
          f"{st['decode_s'] * 1e3:.1f} ms; launch counts {counts}")
    if counts != want or not counts["flash_attention_fwd"]:
        fail(f"phase 14b: launches {counts}, expected {want}")
    return counts


def flash_card_vs_cpu(torch, dev, seed):
    """Phase 15: the flash path on the card against the CPU and against
    ``_attend``, float32 carrier, ``*=fp``, weights of ``init_params``
    (seed + 4) at the true fan-in scale (``true_fan_in``).  On gpt2-mini
    (4 x 128 tokens from the synthetic corpus): the train loss and its
    gradients in float32 (``train_loss`` on the float32 params; the train
    step's bfloat16 cast of the master params would round the gradients
    to bf16) of the card's flash kernels against (A) the CPU's plain flash, (B) the card's
    ``_attend`` path and (D) the card with the plain flash versions in the
    kernels' place; (C) ``lm_prefill`` logits (2 x 64 prompt, 80 rows)
    under flash against ``_attend`` on the card.  On GPT-2 small (E): one
    loss and gradient, 2 x 512 tokens, flash against ``_attend`` on the
    card.  Each within ``FLASH_LIMITS``."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
    lim = FLASH_LIMITS
    ok = True

    def grads(cfg, impl, params, toks, device, swap=()):
        model = build_model(dataclasses.replace(cfg, attention_impl=impl))
        leaves, struct = tree_flatten(params)
        leaves = [t.to(device).requires_grad_(True) for t in leaves]
        with plain_versions(swap):
            loss, _ = model.train_loss(tree_unflatten(struct, leaves),
                                       {"tokens": toks.to(device)},
                                       policy="*=fp")
            g = torch.autograd.grad(loss, leaves)
        return loss.item(), list(g)

    def report(label, a, b):
        d_ce, rel = abs(a[0] - b[0]), _rel_l2(torch, a[1], b[1])
        good = d_ce <= lim["ce"] and rel <= lim["grads"]
        print(f"flash card vs {label}: ce {a[0]:.7f} vs {b[0]:.7f} (|d| "
              f"{d_ce:.3e}, limit {lim['ce']:.0e}), grads rel L2 {rel:.3e} "
              f"(limit {lim['grads']:.0e}){'' if good else '  <-- FAIL'}")
        return good

    for name, cfg, shape in (
            ("gpt2-mini", get_smoke_config("gpt2-small"), (4, 128)),
            ("gpt2-small", get_config("gpt2-small"), (2, 512))):
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = true_fan_in(build_model(cfg).init_params(
            torch.Generator().manual_seed(seed + 4), device="cpu"), cfg)
        toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
            0, batch_size=shape[0], seq_len=shape[1]))
        card = grads(cfg, "flash_pallas", params, toks, dev)
        ok &= report(f"card _attend ({name}, B)",
                     card, grads(cfg, "xla", params, toks, dev))
        if name != "gpt2-mini":
            continue
        ok &= report(f"cpu plain flash ({name}, A)",
                     card, grads(cfg, "flash_pallas", params, toks, "cpu"))
        ok &= report(f"card plain flash ({name}, D)", card,
                     grads(cfg, "flash_pallas", params, toks, dev,
                           swap=FLASH_KERNELS))
        logits = []
        for impl in ("flash_pallas", "xla"):
            model = build_model(dataclasses.replace(cfg, attention_impl=impl))
            p = tree_map(lambda t: t.to(dev), params)
            lg, _ = model.prefill(p, toks[:2, :64].to(dev), policy="*=fp",
                                  max_seq=80)
            logits.append(lg[:, :cfg.vocab_size].float().cpu())
        err = (logits[0] - logits[1]).abs().max().item()
        good = err <= lim["logits"] and bool(torch.isfinite(logits[0]).all())
        print(f"flash card vs card _attend ({name}, C): lm_prefill logits "
              f"max |d| {err:.3e} (limit {lim['logits']:.0e})"
              f"{'' if good else '  <-- FAIL'}")
        ok &= good
    if not ok:
        fail("phase 15: the flash path out of FLASH_LIMITS")


# ---------------------------------------------------------------------------
# Phases 16, 19, 20 and 21: the dense and MoE families served at their
# published widths
# ---------------------------------------------------------------------------

#: phase 16a: #3's (K, N) pairs in a Yi-6B layer -- wq and wo (4096, 4096),
#: wk and wv (4096, 512), w_gate and w_up (4096, 11008), w_down (11008,
#: 4096) -- at the decode step's 16 slots and a 2048-row prefill (the rows
#: of every serving cell)
YI_INT8_KN = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096))
YI_INT8_ROWS = (16, 2048)
#: the decode step's seven linears of one layer, in call order
YI_DECODE_KN = ((4096, 4096), (4096, 512), (4096, 512), (4096, 4096),
                (4096, 11008), (4096, 11008), (11008, 4096))
#: #11 at Yi's prefill: 2 prompts of 2048 over 4096-row buffers, 32 heads
#: over 4 KV heads of 128 (B, Sq, Skv, H, K, hd)
YI_Q8_SHAPE = (2, 2048, 4096, 32, 4, 128)
#: phases 16b and 16c: 16 slots of 4096 rows, 32 requests of 128-2048
#: prompt tokens, 32 new tokens each, 16 of the 32 layers (cut to hold the
#: script's time budget, PERF.md section 4); the paged engine's pages hold
#: 64 rows
YI_REQUESTS, YI_NEW, YI_SLOTS, YI_SEQ = 32, 32, 16, 4096
YI_SERVE_LAYERS = 16
YI_PROMPT = (128, 2048)
#: the block linears of a gated (llama, gemma, qwen3) layer
YI_LINEARS = 7
#: phase 16d, policy B at Yi-6B's width and 2 layers: phase 5's B_LIMIT
#: (0.1) cannot hold there.  Readings at seeds 0-3 (``tools/yi_readings.py``,
#: PERF.md): the card against the CPU 0.095-0.188, and the kernels' plain
#: versions on the card against the CPU 0.089-0.216 -- PyTorch's own fp32
#: ops on the two devices, carried by the per-token int8 codec across
#: 4,096- and 11,008-wide rows (1.4-27% of layer 1's K payloads differ).
#: Set above every reading; what shows the kernels right at this width is
#: the card against the card with the plain int8_matmul in the kernel's
#: place, bit-identical at every seed.
YI_B_LIMIT = 0.3

#: phase 19: Gemma-2B -- wq and wo (2048, 2048), wk and wv (2048, 256),
#: w_gate and w_up (2048, 16384), w_down (16384, 2048); #11 at 2 prompts of
#: 2048 over 8192-row buffers, 8 query heads over one KV head of 256; #12
#: and #13 at 16 slots of 8192 rows, 8 query rows a KV head of 256
GEMMA_INT8_KN = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
GEMMA_DECODE_KN = ((2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
                   (2048, 16384), (2048, 16384), (16384, 2048))
GEMMA_Q8_SHAPE = (2, 2048, 8192, 8, 1, 256)
GEMMA_DECODE_SHAPE = (16, 8192, 1, 8, 256)
#: phase 20: Qwen3-32B's (K, N) -- wq (5120, 8192), wk and wv (5120, 1024),
#: wo (8192, 5120), w_gate and w_up (5120, 25600), w_down (25600, 5120);
#: its attention shapes are Yi's (8 query rows a KV head of 128), held in
#: phase 16a
QWEN3_INT8_KN = ((5120, 8192), (5120, 1024), (8192, 5120), (5120, 25600),
                 (25600, 5120))
QWEN3_DECODE_KN = ((5120, 8192), (5120, 1024), (5120, 1024), (8192, 5120),
                   (5120, 25600), (5120, 25600), (25600, 5120))
#: phase 20: 16 of Qwen3-32B's 64 layers: an fp32 init of all 32.8 B
#: parameters is about 131 GB, more than one card; at 16 layers it is
#: about 37 GB, about 11 GB once prepared
QWEN3_LAYERS = 16
#: phases 19d and 20b, policy B at 2 layers of Gemma-2B's and Qwen3-32B's
#: widths, each the geometric mean, to two digits, of the card-vs-CPU
#: readings' largest and the bf16-carrier control's smallest at seeds 0-3
#: (``tools/dense_readings.py``, PERF.md; H100 80GB HBM3, 700 W): Gemma
#: 0.047-0.092 against controls 0.140-0.176, Qwen3 0.118-0.231 against
#: 0.351-0.389.  The plain versions on the card read 0.056-0.077 and
#: 0.114-0.221: PyTorch's own fp32 ops on the two devices, carried by the
#: per-token codec; the card with the plain int8_matmul in the kernel's
#: place is bit-identical at every seed.  Policy A reads 2.1e-4 to 1.0e-3
#: (Gemma) and 2.9e-3 to 4.2e-3 (Qwen3) under phase 5's 1e-2, its
#: controls 0.065-0.066 and 0.183-0.207.
GEMMA_B_LIMIT = 0.11
QWEN3_B_LIMIT = 0.28

#: phase 21: Granite-3.0-MoE 3B-A800M -- the attention linears on the 2-D
#: #3, wq and wo (1536, 1536), wk and wv (1536, 512); #11 at 2 prompts of
#: 2048 over 4096-row buffers, 24 query heads over 8 KV heads of 64 (G =
#: 3); #12 and #13 at 16 slots of 4096 rows
GRANITE_INT8_KN = ((1536, 1536), (1536, 512))
GRANITE_DECODE_KN = ((1536, 1536), (1536, 512), (1536, 512), (1536, 1536))
GRANITE_Q8_SHAPE = (2, 2048, 4096, 24, 8, 64)
GRANITE_DECODE_SHAPE = (16, 4096, 8, 3, 64)
#: phase 21a: #3's expert-batched instance at each MoE model's experts --
#: (tag, E, the (K, N) of w_gate and w_up, then w_down, the rows an
#: expert): Granite's 40 experts at the decode step's C = 8 (16 slots,
#: ``_capacity(16)``) and a 16,384-token prefill chunk's 4,097 (an odd row
#: count); Phi-3.5-MoE's 16 at its decode step's 3 and its chunk's 2,561
EXPERT_CASES = (("granite", 40, ((1536, 512), (512, 1536)), (8, 4097)),
                ("phi3.5-moe", 16, ((4096, 6400), (6400, 4096)), (3, 2561)))
#: the projections an MoE layer runs on the expert-batched #3 (gate, up,
#: down), and the 2-D ones of its attention
EXPERT_PROJECTIONS, MOE_ATTN_LINEARS = 3, 4
#: phase 21d, policy B at Granite's width and 2 layers, the CPU on the
#: card's routes (``routes_replayed``): the geometric mean, to two digits,
#: of the readings' largest and the bf16-carrier control's smallest at
#: seeds 0-3 (``tools/moe_readings.py``, PERF.md; H100 80GB HBM3, 700 W):
#: 0.034-0.079 against controls 0.183-0.193.  Each device routing on its
#: own, 0.09-3.8% of the (token, k) choices differ and the logits move by
#: up to 0.68, as far as the control's: a flipped near-tie sends a token
#: to another expert.  Policy A reads 5.3e-4 to 4.5e-3 under phase 5's
#: 1e-2, its controls 0.105-0.125.
GRANITE_B_LIMIT = 0.12


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """A model served at its published width (phases 16, 19-21, 23, 25):
    its config and depth (``layers``, None: the config's), #3's distinct
    (K, N) and the decode step's 2-D linears of a layer in call order
    (seven a dense gated layer, an MoE layer's four attention ones),
    #11's and #12/#13's shapes (None: an earlier phase holds the same
    shape), the serving run -- slots x rows, the requests, their prompt
    lengths (drawn from ``--seed``) and new tokens each -- and the card
    against the CPU at 2 layers: policy B's limit and whether the
    bf16-carrier control runs."""
    phase: str
    tag: str
    arch: str
    int8_kn: tuple
    decode_kn: tuple
    q8_shape: tuple | None
    decode_shape: tuple | None
    slots: int
    seq: int
    requests: int
    prompt: tuple
    new: int
    b_limit: float
    control: bool = False
    layers: int | None = None
    #: prompt lengths by admission wave, ``slots`` requests a wave, each
    #: wave of one prefill bucket (None: ``requests`` drawn from
    #: ``prompt``): the dense engine then prefills each wave in one launch,
    #: as the paged engine does (phase 21c)
    waves: tuple | None = None
    #: the rows at which phase 16a holds #3 (the decode step's 16, then
    #: prefill and training rows)
    rows: tuple = (16, 2048)
    #: the hybrid's shared-block linears in call order, run once a group of
    #: ``hybrid_attn_every`` layers (``decode_kn`` then holds an SSM
    #: layer's)
    shared_kn: tuple = ()
    #: the depth of the card-against-CPU check (``cell_card_vs_cpu``)
    cmp_layers: int = 2

    def config(self, **kw):
        from repro_torch.configs import get_config
        if self.layers:
            kw = {"n_layers": self.layers, **kw}
        return dataclasses.replace(get_config(self.arch), **kw)

    def step_linears(self, cfg=None) -> int:
        """The 2-D block linears of one decode step (and of one prefill
        launch) across the stack of ``cfg`` (default: the cell's)."""
        cfg = cfg or self.config()
        groups = (cfg.n_layers // cfg.hybrid_attn_every
                  if self.shared_kn else 0)
        return (len(self.decode_kn) * cfg.n_layers
                + len(self.shared_kn) * groups)


YI = ServeCell("16", "yi", "yi-6b", YI_INT8_KN, YI_DECODE_KN, YI_Q8_SHAPE,
               YI_DECODE_SHAPE, YI_SLOTS, YI_SEQ, YI_REQUESTS, YI_PROMPT,
               YI_NEW, YI_B_LIMIT, layers=YI_SERVE_LAYERS)
GEMMA = ServeCell("19", "gemma", "gemma-2b", GEMMA_INT8_KN, GEMMA_DECODE_KN,
                  GEMMA_Q8_SHAPE, GEMMA_DECODE_SHAPE, slots=16, seq=8192,
                  requests=32, prompt=(256, 6144), new=32,
                  b_limit=GEMMA_B_LIMIT, control=True)
QWEN3 = ServeCell("20", "qwen3", "qwen3-32b", QWEN3_INT8_KN, QWEN3_DECODE_KN,
                  None, None, slots=16, seq=4096, requests=16,
                  prompt=(128, 2048), new=32, b_limit=QWEN3_B_LIMIT,
                  control=True, layers=QWEN3_LAYERS)
#: phases 21b and 21c serve 16 of Granite's 32 layers (cut to hold the
#: script's time budget, PERF.md section 4)
GRANITE_SERVE_LAYERS = 16
GRANITE = ServeCell("21", "granite", "granite-moe-3b-a800m", GRANITE_INT8_KN,
                    GRANITE_DECODE_KN, GRANITE_Q8_SHAPE,
                    GRANITE_DECODE_SHAPE, slots=16, seq=4096, requests=32,
                    prompt=(129, 2048), new=32, b_limit=GRANITE_B_LIMIT,
                    control=True, waves=((1025, 2048), (129, 256)),
                    layers=GRANITE_SERVE_LAYERS)


def check_int8_cell(torch, dev, gen, results, cell=YI):
    """Phase 16a (19a, 20a: ``cell``), #3 at ``cell.int8_kn`` x
    ``YI_INT8_ROWS``, bf16 output: the wrapper (and at M = 16 the cluster
    route twice, a repeat bit-identical) bit for bit against the plain
    version, timed queued and call by call beside the bound, the plain
    version and ``torch._int_mm`` (queued; at M = 16 on x zero-padded to 17
    rows); the fused decode entry ``int8_quant_matmul`` bit for bit at M =
    16 on bf16 rows (an all-zero row among them), a repeat bit-identical,
    and on rows holding a NaN or an infinity; the weight transpose that the
    tensor-core route runs on every call, timed alone; and the decode
    step's seven linears of a layer through the fused entry over four
    layers' distinct weights (the L2 cold), ms per call beside the round's
    byte bound.  Phase 23a holds Mamba2-130M's projections so at
    ``cell.rows``."""
    import importlib
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    from repro_torch.core.qconfig import Granularity, QuantSpec
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    dt = torch.bfloat16
    label = f"phase {cell.phase}a"
    n_layers = cell.config().n_layers
    rows = []
    for k, n in cell.int8_kn:
        for m in cell.rows:
            x, w, rs, cs = _int8_case(torch, dev, gen, m, k, n)
            want = im.int8_matmul_plain(x, w, rs, cs, out_dtype=dt)
            got = {"wrapper": im.int8_matmul(x, w, rs, cs, out_dtype=dt)}
            if m <= im.FWD_GEMV_MAX_M:
                got["gemv"] = im.int8_matmul_gemv(x, w, rs, cs, dt)
                got["gemv repeat"] = im.int8_matmul_gemv(x, w, rs, cs, dt)
            torch.cuda.synchronize()
            for name, g in got.items():
                if not torch.equal(g, want):
                    fail(f"{label} int8_matmul ({name}) M={m} K={k} N={n}: "
                         f"not bit-exact (max err "
                         f"{(g.float() - want.float()).abs().max().item()})")
            fn = (lambda: im.int8_matmul(x, w, rs, cs, dt))
            xl = x if m > 16 else torch.nn.functional.pad(
                x, (0, 0, 0, 17 - m))
            b, by = bound_ms(m * k + k * n + 4 * (m + n) + 2 * m * n,
                             2.0 * m * n * k, INT8_OPS)
            row = dict(shape=f"M={m},K={k},N={n},bfloat16",
                       fwd_route=im.fwd_route(m, n, k), max_abs_err=0.0,
                       ms=queued_ms(fn), ms_call=time_ms(fn),
                       plain_ms=time_ms(lambda: im.int8_matmul_plain(
                           x, w, rs, cs, dt), iters=3),
                       bound_ms=b, bound_by=by,
                       library_ms=queued_ms(lambda: torch._int_mm(xl, w)))
            if m <= im.FWD_GEMV_MAX_M:
                xf = (torch.randn((m, k), generator=gen, device=dev)
                      * 3).to(dt)
                xf[m // 2] = 0.0
                fwant = im.int8_quant_matmul_plain(xf, w, cs, spec, dt)
                fgot = im.int8_quant_matmul(xf, w, cs, spec, dt)
                again = im.int8_quant_matmul(xf, w, cs, spec, dt)
                xb = xf.clone()
                xb[3, k - 1] = float("nan")
                xb[5, 0] = float("inf")
                xb[9, k // 2] = float("-inf")
                xb[11, 1], xb[11, 2] = float("nan"), float("inf")
                bwant = im.int8_quant_matmul_plain(xb, w, cs, spec, dt)
                bgot = im.int8_quant_matmul(xb, w, cs, spec, dt)
                torch.cuda.synchronize()
                same = (bgot == bwant) | (bgot.isnan() & bwant.isnan())
                if not (torch.equal(fgot, fwant) and torch.equal(again, fgot)
                        and bool(same.all())
                        and bool(bgot[[3, 11]].isnan().all())):
                    fail(f"{label} int8_quant_matmul M={m} K={k} N={n}: not "
                         f"bit-exact, a repeat differs, or rows holding a NaN "
                         f"or an infinity differ from the plain version")
                ffn = (lambda: im.int8_quant_matmul(xf, w, cs, spec, dt))
                row.update(fused_ms=queued_ms(ffn), fused_ms_call=time_ms(ffn))
            else:
                row["transpose_ms"] = queued_ms(lambda: im.transpose_packed(w))
            rows.append(row)
            extra = (f"; fused entry bit-exact (NaN and inf rows too), "
                     f"queued {row['fused_ms']:.4f} (call by call "
                     f"{row['fused_ms_call']:.4f})" if "fused_ms" in row else
                     f"; its weight transpose alone {row['transpose_ms']:.4f}")
            print(f"{label} int8_matmul M={m:5d} K={k:5d} N={n:5d} bf16: "
                  f"bit-exact (tol 0), route {row['fwd_route']}; queued ms "
                  f"{row['ms']:.4f} (call by call {row['ms_call']:.4f}), "
                  f"plain_ms {row['plain_ms']:.4f}, bound_ms "
                  f"{row['bound_ms']:.5f} ({by}), library_ms (torch._int_mm"
                  f"{'' if m > 16 else ' on 17 rows'}, queued) "
                  f"{row['library_ms']:.4f}{extra}")
            del x, w, rs, cs, want, got
    # the transposes a prefill launch runs: every layer's 2-D linears (and
    # every invocation's of the hybrid's shared block)
    linears = len(cell.decode_kn) + len(cell.shared_kn)
    per_step = cell.step_linears()

    def transposes(kns):
        return sum(next(r["transpose_ms"] for r in rows
                        if r["shape"].startswith(
                            f"M={cell.rows[-1]},K={k},N={n},"))
                   for k, n in kns)
    groups = n_layers // max(cell.config().hybrid_attn_every, 1)
    launch_ms = (n_layers * transposes(cell.decode_kn)
                 + (groups * transposes(cell.shared_kn)
                    if cell.shared_kn else 0.0))
    print(f"{label} int8_matmul: the tensor-core route's weight transposes "
          f"of one prefill launch ({per_step} linears, queued): "
          f"{launch_ms:.3f} ms")
    args = []
    for _ in range(4):
        for k, n in cell.decode_kn + cell.shared_kn:
            _, w, _, cs = _int8_case(torch, dev, gen, 16, k, n)
            xf = torch.randn((16, k), generator=gen, device=dev).to(dt)
            args.append((xf, w, cs, spec, dt))
    nbytes = sum(a[0].numel() * 2 + a[1].numel() + 4 * a[1].shape[1]
                 + 2 * 16 * a[1].shape[1] for a in args)
    cold = dict(weights=len(args),
                weight_bytes=sum(a[1].numel() for a in args),
                bound_ms=nbytes / HBM_BPS * 1e3 / len(args),
                ms=time_cold_ms(im.int8_quant_matmul, args, 2 * len(args),
                                len(args), queued=True),
                ms_call=time_cold_ms(im.int8_quant_matmul, args,
                                     2 * len(args), len(args)))
    print(f"{label} int8_quant_matmul L2 cold, a round over a layer's "
          f"{linears} linears x 4 ({cold['weight_bytes'] / 1e6:.1f} MB) at "
          f"M = 16: ms per call queued {cold['ms']:.4f}, call by call "
          f"{cold['ms_call']:.4f}; bound {cold['bound_ms']:.5f} (bytes); a "
          f"decode step's {per_step}: {per_step * cold['ms']:.3f} ms queued")
    del args
    results["int8_matmul"][cell.tag] = dict(shapes=rows, l2_cold=cold)


def _experts_case(torch, dev, gen, e, c, k, n):
    """E experts' int8 payloads x (E, c, k), w (E, k, n) and scales rs (E,
    c, 1), cs (E, 1, n), every 7th row scale 0 (the guard maps it to 1)."""
    x = torch.randint(-128, 128, (e, c, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (e, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    rs = torch.rand((e, c, 1), generator=gen, device=dev) * 0.05
    cs = torch.rand((e, 1, n), generator=gen, device=dev) * 0.01
    rs[:, ::7] = 0.0
    return x, w, rs, cs


def check_int8_experts(torch, dev, gen, results):
    """Phase 21a, #3's expert-batched instance (``int8_matmul_experts``) at
    ``EXPERT_CASES``, bf16 output: one launch bit for bit against its plain
    version (the 2-D plain version expert by expert), against E launches of
    the 2-D entry, and against a second launch of itself; at the decode
    step's rows also the fused entry ``int8_quant_matmul_experts`` on bf16
    rows (an all-zero row among them) the same three ways.  Each timed
    queued and call by call beside its bound (bytes at the decode rows,
    operations at the prefill chunk's), its plain version and a library
    yardstick: E ``torch._int_mm`` calls, queued (x zero-padded to 17 rows
    where it has fewer)."""
    import importlib
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    from repro_torch.core.qconfig import Granularity, QuantSpec
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    dt = torch.bfloat16
    rows = []
    for tag, e, kns, cs_rows in EXPERT_CASES:
        for k, n in kns:
            for c in cs_rows:
                x, w, rs, cs = _experts_case(torch, dev, gen, e, c, k, n)
                want = im.int8_matmul_experts_plain(x, w, rs, cs, dt)
                got = im.int8_matmul_experts(x, w, rs, cs, dt)
                again = im.int8_matmul_experts(x, w, rs, cs, dt)
                per = torch.stack([im.int8_matmul(x[i], w[i], rs[i], cs[i],
                                                  dt) for i in range(e)])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not (torch.equal(got, want) and torch.equal(again, got)
                        and torch.equal(per, got)):
                    fail(f"phase 21a int8_matmul_experts {tag} E={e} C={c} "
                         f"K={k} N={n}: not bit-exact against the plain "
                         f"version (max err {err}), a repeat or {e} 2-D "
                         f"launches")
                fn = (lambda: im.int8_matmul_experts(x, w, rs, cs, dt))
                xl = x if c > 16 else torch.nn.functional.pad(
                    x, (0, 0, 0, 17 - c))
                b, by = bound_ms(e * (c * k + k * n + 4 * (c + n)
                                      + 2 * c * n),
                                 2.0 * e * c * n * k, INT8_OPS)
                row = dict(
                    shape=f"E={e},C={c},K={k},N={n},bfloat16", model=tag,
                    fwd_route=im.fwd_route(c, n, k), max_abs_err=err,
                    ms=queued_ms(fn), ms_call=time_ms(fn),
                    plain_ms=time_ms(lambda: im.int8_matmul_experts_plain(
                        x, w, rs, cs, dt), iters=3),
                    bound_ms=b, bound_by=by,
                    library_ms=queued_ms(lambda: [torch._int_mm(xl[i], w[i])
                                                  for i in range(e)]),
                    library=f"{e} x torch._int_mm" + (
                        "" if c > 16 else " on x zero-padded to 17 rows"))
                if c <= im.FWD_GEMV_MAX_M:
                    xf = (torch.randn((e, c, k), generator=gen, device=dev)
                          * 3).to(dt)
                    xf[0, c // 2] = 0.0
                    fwant = im.int8_quant_matmul_experts_plain(xf, w, cs,
                                                               spec, dt)
                    fgot = im.int8_quant_matmul_experts(xf, w, cs, spec, dt)
                    fagain = im.int8_quant_matmul_experts(xf, w, cs, spec,
                                                          dt)
                    fper = torch.stack([im.int8_quant_matmul(
                        xf[i], w[i], cs[i], spec, dt) for i in range(e)])
                    torch.cuda.synchronize()
                    if not (torch.equal(fgot, fwant)
                            and torch.equal(fagain, fgot)
                            and torch.equal(fper, fgot)):
                        fail(f"phase 21a int8_quant_matmul_experts {tag} "
                             f"E={e} C={c} K={k} N={n}: not bit-exact "
                             f"against the plain version, a repeat or {e} "
                             f"2-D launches")
                    ffn = (lambda: im.int8_quant_matmul_experts(
                        xf, w, cs, spec, dt))
                    fb, _ = bound_ms(e * (2 * c * k + k * n + 4 * n
                                          + 2 * c * n),
                                     2.0 * e * c * n * k, INT8_OPS)
                    row.update(fused_ms=queued_ms(ffn),
                               fused_ms_call=time_ms(ffn), fused_bound_ms=fb)
                rows.append(row)
                extra = (f"; fused entry bit-exact (plain, repeat, {e} 2-D "
                         f"launches), queued {row['fused_ms']:.4f} (call by "
                         f"call {row['fused_ms_call']:.4f}), bound "
                         f"{row['fused_bound_ms']:.5f}"
                         if "fused_ms" in row else "")
                print(f"phase 21a int8_matmul_experts {tag} E={e} C={c:5d} "
                      f"K={k:5d} N={n:5d} bf16: bit-exact (tol 0) against "
                      f"the plain version, a repeat and {e} 2-D launches, "
                      f"route {row['fwd_route']}; queued ms {row['ms']:.4f} "
                      f"(call by call {row['ms_call']:.4f}), plain_ms "
                      f"{row['plain_ms']:.4f}, bound_ms {b:.5f} ({by}), "
                      f"library_ms ({row['library']}, queued) "
                      f"{row['library_ms']:.4f}{extra}")
                del x, w, rs, cs, want, got, again, per
    # the JSON entry reports Granite's w_gate / w_up at the decode step's 8
    # rows an expert (two of every three launches); kernels.json keeps all
    results["int8_matmul_experts"] = dict(
        route="cuda", source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:84", tol=0.0,
        shapes=rows, **rows[0])


def cell_kernels(torch, dev, gen, results, cell=YI):
    """Phase 16a (19a, 20a: ``cell``): #3, #11, #12 and #13 at the cell's
    shapes against their plain versions with phase 3's gates (#12 and #13
    with the positions on the chunk edges, #13 at pages of 16, 64 and 256
    bit for bit against #12 on the same logical cache); a shape of None is
    left to the phase that holds it."""
    check_int8_cell(torch, dev, gen, results, cell)
    if cell.q8_shape:
        check_flash_q8(torch, dev, gen, results, shapes=(cell.q8_shape,),
                       tag=cell.tag)
    if cell.decode_shape:
        check_decode_attention(torch, dev, gen, results,
                               shape=cell.decode_shape, tag=cell.tag)
        check_decode_attention_paged(torch, dev, gen, results,
                                     shape=cell.decode_shape, tag=cell.tag)
    if cell.config().n_experts:
        check_int8_experts(torch, dev, gen, results)


def cell_prompts(cell, cfg, seed):
    """The cell's prompts (``cell.prompt`` tokens, or ``cell.slots`` a
    wave in each of ``cell.waves``; lengths and tokens drawn from
    ``seed``)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    if cell.waves:
        lens = np.concatenate([rng.randint(lo, hi + 1, size=cell.slots)
                               for lo, hi in cell.waves])
    else:
        lens = rng.randint(cell.prompt[0], cell.prompt[1] + 1,
                           size=cell.requests)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def serve_launches(cfg, prefills, decode_steps, attn):
    """The launches a serving run must count: every layer's 2-D block
    linears (7 a dense gated layer, 4 an MoE one's attention, an SSM
    layer's 5 projections) and one #11 a prefill launch, those linears and
    one ``attn`` (#12 or #13) a decode step -- no attention kernel in the
    SSM family; the hybrid's attention and its 8 shared-block linears once
    a group of ``hybrid_attn_every`` SSM layers; an MoE layer's three expert projections once a decode
    step and once a dispatch chunk of each prefill launch of ``prefills``
    (its (B, S) token shapes; ``models/moe.dispatch_chunk``)."""
    from repro_torch.models.moe import dispatch_chunk
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"int8_matmul": SSM_LINEARS * L * (len(prefills)
                                                  + decode_steps)}
    if cfg.family == "hybrid":
        # an SSM layer's projections, and the shared block's linears once a
        # group, whose attention is one #11 a prefill, one #12 a step
        groups = L // cfg.hybrid_attn_every
        linears = SSM_LINEARS * L + HYBRID_SHARED_LINEARS * groups
        return {"int8_matmul": linears * (len(prefills) + decode_steps),
                "flash_attention_fwd_q8": groups * len(prefills),
                attn: groups * decode_steps}
    linears = MOE_ATTN_LINEARS if cfg.n_experts else YI_LINEARS
    want = {"int8_matmul": linears * L * (len(prefills) + decode_steps),
            "flash_attention_fwd_q8": L * len(prefills),
            attn: L * decode_steps}
    if cfg.n_experts:
        chunks = sum(b * s // dispatch_chunk(b * s) for b, s in prefills)
        want["int8_matmul_experts"] = (EXPERT_PROJECTIONS * L
                                       * (decode_steps + chunks))
    return want


def _cell_serve_run(torch, eng, cfg, cell, prompts, label):
    """Serve ``prompts`` to length through ``eng``'s queue with the counts
    and the peak memory reset before; checks every request's new tokens and
    the launch counts against the engine's own prefill and decode counts
    and the logged shapes of its prefill launches (``serve_launches``).
    Returns (counts, tokens by request in submit order, stats)."""
    from repro_torch import kernels
    from repro_torch.infer import Request
    ids = [eng.submit(Request(tokens=p, max_new_tokens=cell.new))
           for p in prompts]
    prefills = []                # (B, S) of every prefill launch
    call = eng._prefill_call

    def logged(toks, last, segs=None):
        prefills.append(toks.shape)
        return call(toks, last, segs)
    eng._prefill_call = logged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del eng._prefill_call
    st = dict(eng.stats)
    if sorted(r.request_id for r in out) != sorted(ids):
        fail(f"{label}: not every request answered")
    for r in out:
        if (len(r.tokens) != cell.new or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"{label}: request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    gen_tok = sum(len(r.tokens) for r in out)
    lat = eng.scheduler.latency_stats()
    dec_ms = st["decode_s"] * 1e3 / max(st["decode_steps"], 1)
    print(f"{label}: {eng.path_summary()}, {cfg.name} {cfg.n_layers}L d="
          f"{cfg.d_model} H={cfg.n_heads} K={cfg.n_kv_heads} hd="
          f"{cfg.head_dim} carrier {cfg.dtype}, {cell.slots} slots x "
          f"{cell.seq} rows, {len(out)} requests of {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} prompt tokens, {cell.new} new each: "
          f"{gen_tok} tokens in {wall:.3f} s ({gen_tok / wall:.1f} tok/s end "
          f"to end); prefill {st['prefill_calls']} launches "
          f"{st['prefill_s'] * 1e3:.1f} ms ({st['prefill_tokens']} prompt "
          f"tokens, {st['prefill_tokens'] / max(st['prefill_s'], 1e-9):.0f} "
          f"tok/s); decode {st['decode_steps']} steps "
          f"{st['decode_s'] * 1e3:.1f} ms ({dec_ms:.2f} ms/step, "
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tok/s); "
          f"latency p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated at rest {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB)")
    print(f"{label}: launch counts {counts}; prefill launches (B, S) "
          f"{prefills}")
    attn = "decode_attention_paged" if eng.paged else "decode_attention"
    want = serve_launches(cfg, prefills, st["decode_steps"], attn)
    if len(prefills) != st["prefill_calls"]:
        fail(f"{label}: {len(prefills)} prefill launches logged, the engine "
             f"counts {st['prefill_calls']}")
    for name, n in counts.items():
        if n != want.get(name, 0) or (name in want and n <= 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")
    tokens = {r.request_id: r.tokens for r in out}
    return counts, [tokens[i] for i in ids], st


def _head_ms(torch, eng, cfg, rows):
    """Device ms of the decode step's head on ``rows`` rows, queued: the
    whole ``logits_chunk``, and apart its fp32 upcast of the (d, V) head
    (the tied embedding table under ``tie_embeddings``) and the fp32
    product."""
    from repro_torch.models.lm import logits_chunk
    h = torch.randn((rows, 1, cfg.d_model), device="cuda").bfloat16()
    head = (eng.params["embed"].t() if cfg.tie_embeddings
            else eng.params["lm_head"])
    hf = head.to(torch.float32)
    return dict(head_ms=queued_ms(lambda: logits_chunk(eng.params, h, cfg,
                                                       eng.policy)),
                upcast_ms=queued_ms(lambda: head.to(torch.float32)),
                product_ms=queued_ms(lambda: torch.matmul(
                    h.to(torch.float32), hf)))


def _state_parts(eng) -> str:
    """The engine state's two parts, their shapes and sizes."""
    parts = []
    for part in ("caches", "ssm"):
        bufs = eng._state[part]
        parts.append(f"{part} " + ", ".join(
            f"{k} {tuple(t.shape)}" for k, t in bufs.items())
            + f" ({sum(t.numel() * t.element_size() for t in bufs.values()) / 1e9:.3f} GB)")
    return "; ".join(parts)


def serve_cell(torch, dev, seed, cell=YI):
    """Phase 16b (19b, 20a: ``cell``): the cell's model at its published
    width and ``cell.layers`` deep, random float32 weights from ``seed``
    on the card's generator, freed once the engine has prepared them: the
    dense engine under ``POLICY`` (bf16 carrier, W8A8 prepared weights,
    int8 KV), ``cell.slots`` slots of ``cell.seq`` rows, the requests of
    ``cell_prompts``.  Each kernel launches as often as the engine's
    counts say (7 #3 a layer and one #12 a decode step, 7 #3 and one #11 a
    layer a prefill launch), and the run ends on rung 0 with no demotion;
    then one profiled decode step and the head's share.  Returns (counts,
    tokens, stats, the engine's prepared parameters for the paged run)."""
    import numpy as np
    from repro_torch.infer import Engine
    from repro_torch.infer.prepare import params_nbytes
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cell.config()
    model = build_model(cfg)
    label = f"phase {cell.phase}{'a' if cell.phase == '20' else 'b'}"
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    fp32_bytes = params_nbytes(params)
    eng = Engine(model, params, POLICY, max_slots=cell.slots,
                 max_seq=cell.seq, device=dev, seed=seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ssm = eng._state["caches"] is None
    state = {"ssm": "SSM and conv state, no KV cache",
             "hybrid": "int8 KV cache (one strip a shared-block invocation)"
                       " and SSM and conv state"}.get(cfg.family,
                                                      "int8 KV cache")
    print(f"{label}: {cfg.name} ({cfg.n_layers} layers) float32 weights "
          f"{fp32_bytes / 1e9:.2f} GB drawn and prepared in "
          f"{time.perf_counter() - t0:.1f} s, freed; the engine holds "
          f"{params_nbytes(eng.params) / 1e9:.2f} GB of parameters (int8 "
          f"block weights, bf16 "
          f"{'tied embedding' if cfg.tie_embeddings else 'embedding and head'}"
          f") and {eng.kv_cache_nbytes() / 1e9:.3f} GB of {state}; "
          + (_state_parts(eng) + "; " if cfg.family == "hybrid" else "")
          + eng.path_summary())
    if cfg.family == "ssm" and not (ssm and eng.path_summary().endswith(
            "kv=none")):
        fail(f"{label}: the SSM engine holds a KV cache")
    if cfg.family == "hybrid" and (ssm or eng._state["ssm"] is None
                                   or "kv=int8-fused" not in
                                   eng.path_summary()):
        fail(f"{label}: the hybrid engine lacks its KV cache, its SSM "
             f"states or the fused KV path")
    prompts = cell_prompts(cell, cfg, seed)
    counts, tokens, st = _cell_serve_run(torch, eng, cfg, cell, prompts,
                                         f"{label} engine")
    healthy(eng, label)
    profile_decode(torch, eng, cfg, np.random.RandomState(seed + 3))
    head = _head_ms(torch, eng, cfg, cell.slots)
    v, d = cfg.vocab_padded, cfg.d_model
    print(f"{label}: the {'tied' if cfg.tie_embeddings else 'untied'} head "
          f"on {cell.slots} rows, queued: logits_chunk {head['head_ms']:.4f} "
          f"ms a decode step, of which its fp32 upcast of the ({d}, {v}) "
          f"head alone {head['upcast_ms']:.4f} ms and the fp32 product "
          f"alone {head['product_ms']:.4f} ms")
    eng.scheduler.stop()
    return counts, tokens, st, eng.params


def serve_cell_paged(torch, dev, seed, params, dense_tokens, dense_stats,
                     cell=YI):
    """Phase 16c (19c: ``cell``): the dense run's requests through the
    paged engine (pages of 64 rows, the default pool) on the same prepared
    parameters: the tokens equal the dense run's, one #13 a layer a decode
    step (no #12), rung 0 to the end, every page back after the run."""
    import numpy as np
    from repro_torch.infer import Engine
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cell.config()
    label = f"phase {cell.phase}c"
    eng = Engine(build_model(cfg), params, POLICY, max_slots=cell.slots,
                 max_seq=cell.seq, device=dev, seed=seed, paged=True,
                 page_size=PAGE)
    counts, tokens, st = _cell_serve_run(
        torch, eng, cfg, cell, cell_prompts(cell, cfg, seed),
        f"{label} paged engine")
    healthy(eng, label)
    for i, (got, want) in enumerate(zip(tokens, dense_tokens)):
        if got != want:
            at = next(j for j, (a, c) in enumerate(zip(got, want)) if a != c)
            fail(f"{label}: request {i} differs from the dense engine's at "
                 f"token {at} ({got[at]} vs {want[at]})")
    if eng.pool.free_pages != eng.n_pages - 1 or eng.pool.live_pages:
        fail(f"{label}: pages kept after the run: {eng.pool.free_pages} "
             f"free of {eng.n_pages - 1}")
    dense_ms = dense_stats["decode_s"] * 1e3 / max(dense_stats["decode_steps"],
                                                   1)
    print(f"{label}: tokens equal to the dense engine's for all "
          f"{len(tokens)}; {eng.n_pages} pages of {PAGE} rows, every page "
          f"back; peak live KV {eng.scheduler.peak_live_bytes / 1e9:.3f} GB "
          f"of the dense cache's {eng.kv_cache_nbytes() / 1e9:.3f} GB pool; "
          f"decode {st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} "
          f"ms/step against the dense engine's {dense_ms:.2f}")
    profile_decode(torch, eng, cfg, np.random.RandomState(seed + 3))
    eng.scheduler.stop()
    return counts


def cell_card_vs_cpu(torch, dev, seed, cell=YI, strict=True):
    """Phase 16d (19d, 20b, 21d, 23c, 25c: ``cell``): phase 5 at the cell's
    full width and ``cell.cmp_layers`` layers (float32 carrier, ``true_fan_in`` weights, the gated leaves and
    the norms included), with phase 5's A check and limit, and its B check
    with ``cell.b_limit``; under ``cell.control`` also the card at the bf16
    carrier, which must exceed each limit.  Returns the readings;
    ``strict=False`` (``tools/dense_readings.py``) fails nothing."""
    gc.collect()
    torch.cuda.empty_cache()
    return card_vs_cpu(torch, dev, seed, cfg=cell.config(
        n_layers=cell.cmp_layers, dtype="float32"), b_limit=cell.b_limit,
        control=cell.control, strict=strict)


def _serve_ladder_engine(dev, seed, model, params, policy, paged, **kw):
    from repro_torch.infer import Engine
    if paged:
        kw.update(paged=True, page_size=PAGE)
    return Engine(model, params, policy, max_slots=SERVE_SLOTS,
                  max_seq=SERVE_SEQ, device=dev, seed=seed, **kw)


def _serve_counted(torch, eng, prompts, label):
    """Serve ``prompts`` (64 new tokens each) through ``eng``'s queue with
    the launch counts reset before; -> (responses in submit order, counts,
    wall seconds)."""
    from repro_torch import kernels
    from repro_torch.infer import Request
    ids = [eng.submit(Request(tokens=p, max_new_tokens=SERVE_NEW))
           for p in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = {r.request_id: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    eng.scheduler.stop()
    if sorted(out) != sorted(ids):
        fail(f"{label}: not every request answered")
    return [out[i] for i in ids], counts, wall


def serve_dequant(torch, dev, seed):
    """Phase 17a: an engine whose rung 0 is dequantize-on-read
    (``DEQUANT_POLICY``: a per-tensor KV spec, which no kernel takes), dense
    and paged (pages of 64), on phase 4's weights and the 32 requests of
    ``ladder_prompts``.  Every request answered to length; ``path_summary``
    reads ``kv=int8-dequant`` and ``kv=int8-paged-gather(p64)``; exactly
    72 ``int8_matmul`` a decode step and a prefill launch and no other
    kernel; the healthy path never degrades; every page comes back; the
    paged tokens equal the dense ones bit for bit for every request.  (A
    per-tensor scale covers a prompt's whole prefill write block, pad rows
    included: the bucket in the dense engine, the launch's row in the
    paged one.  The prompts share one bucket, a whole number of pages, so
    the two blocks are the same; where they are not, the two engines
    differ in both packages, which
    ``tests/test_torch_serve_ladder.py::test_a8n_paged_differs_from_dense_where_blocks_differ``
    shows on the CPU.)  Returns the launch counts of the two runs."""
    cfg, model, params = serve_model(torch, dev, seed)
    prompts = ladder_prompts(cfg, seed)
    total, tokens = {}, {}
    for paged in (False, True):
        label = f"phase 17a {'paged' if paged else 'dense'}"
        eng = _serve_ladder_engine(dev, seed, model, params,
                                   DEQUANT_POLICY, paged)
        want_kv = "int8-paged-gather(p64)" if paged else "int8-dequant"
        if eng.path_summary().split(" kv=")[1] != want_kv:
            fail(f"{label}: {eng.path_summary()}, expected kv={want_kv}")
        if eng._rungs != ["dequant", "fp"]:
            fail(f"{label}: rungs {eng._rungs}")
        out, counts, wall = _serve_counted(torch, eng, prompts, label)
        st = eng.stats
        for r in out:
            if len(r.tokens) != SERVE_NEW or r.finish_reason != "length":
                fail(f"{label}: request {r.request_id}: {len(r.tokens)} "
                     f"tokens, {r.finish_reason}")
        want = _expect(int8_matmul=6 * cfg.n_layers * (st["prefill_calls"]
                                                       + st["decode_steps"]))
        healthy(eng, label)
        if paged and (eng.pool.free_pages != eng.n_pages - 1
                      or eng.pool.live_pages):
            fail(f"{label}: pages kept after the run: {eng.pool.free_pages} "
                 f"free of {eng.n_pages - 1}")
        print(f"{label}: {eng.path_summary()}, {len(out)} requests of "
              f"{SERVE_NEW} tokens in {wall:.3f} s; prefill "
              f"{st['prefill_calls']} launches {st['prefill_s'] * 1e3:.1f} "
              f"ms, decode {st['decode_steps']} steps "
              f"{st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} "
              f"ms/step; launch counts {counts}")
        if counts != want or not counts["int8_matmul"]:
            fail(f"{label}: launches {counts}, expected {want}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        tokens[paged] = [r.tokens for r in out]
    bad = [i for i, (a, b) in enumerate(zip(tokens[True], tokens[False]))
           if a != b]
    if bad:
        fail(f"phase 17a: paged tokens differ from dense in requests {bad}")
    print(f"phase 17a: paged tokens bit-equal to dense for all "
          f"{len(prompts)} requests")
    return total


def dequant_card_vs_cpu(torch, dev, seed, quiet=False):
    """Phase 17b, teacher-forced as phase 5 (float32 carrier,
    ``true_fan_in`` weights of seed + 1, 2 prompts of 64 tokens + 8
    decode steps).  (i) ``kv_cache=a8n,*=w8c``, dequantize-on-read on the
    card against the CPU: max |d logit| within phase 5's A limit 1e-2,
    top-1 equal wherever the CPU's margin exceeds it.  (ii) an a8t model
    (``kv_cache=a8t,*=w8c``) on its dequant path against its fused path
    (#11, #12), both on the card: max |d logit| within
    ``DEQUANT_FUSED_LIMIT``; the same at the bfloat16 carrier, the control,
    must exceed it.  Returns the three readings."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("gpt2-small"), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    params = true_fan_in(model.init_params(gen, device="cpu"), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64 + 8), generator=gen)
    policy = "kv_cache=a8n,*=w8c"
    cpu, _ = _teacher_forced(torch, model, cfg, params, toks, policy, "cpu")
    card, _ = _teacher_forced(torch, model, cfg, params, toks, policy, dev)
    err, n_agree, n_bad = _agreement(torch, card, cpu, 1e-2)
    a8t = "kv_cache=a8t,*=w8c"
    rungs = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        m = build_model(c)
        for path in ("fused", "dequant"):
            rungs[dtype, path], _ = _teacher_forced(
                torch, m, c, params, toks, a8t, dev, kv_path=path)
    d32 = (rungs["float32", "dequant"] - rungs["float32", "fused"]
           ).abs().max().item()
    d16 = (rungs["bfloat16", "dequant"] - rungs["bfloat16", "fused"]
           ).abs().max().item()
    if quiet:
        return err, d32, d16
    limit = DEQUANT_FUSED_LIMIT
    print(f"phase 17b (i) {policy} card vs cpu (float32 carrier): max "
          f"|dlogit| {err:.3e} (limit 1.0e-02), top-1 agree {n_agree}/"
          f"{cpu.shape[0] * cpu.shape[1]} ({n_bad} disagreements where the "
          f"CPU's top-2 margin > limit)")
    print(f"phase 17b (ii) {a8t} on the card, the dequant rung against the "
          f"fused rung: max |dlogit| {d32:.3e} at float32 (limit "
          f"{limit:.1e}), the bfloat16-carrier control {d16:.3e} (must "
          f"exceed the limit)")
    if not (err <= 1e-2 and n_bad == 0 and bool(torch.isfinite(card).all())):
        fail("phase 17b: the dequant path's card and CPU logits disagree")
    if not d32 <= limit:
        fail(f"phase 17b: dequant rung vs fused rung {d32:.3e} > {limit:.1e}")
    if not d16 > limit:
        fail(f"phase 17b: the bf16 control {d16:.3e} lies within "
             f"{limit:.1e}")
    return err, d32, d16


def serve_ladder(torch, dev, seed):
    """Phase 17c: the walk.  ``POLICY`` dense and paged (pages of 64), the
    first ``SERVE_LADDER_REQUESTS`` of 17a's prompts, 64 new tokens each,
    ``MonitorConfig(reprobe_after=SERVE_LADDER_REPROBE)`` and
    ``SERVE_LADDER_PLAN``.  The transitions equal ``SERVE_LADDER_EXPECT``;
    two kernel errors; exactly two requests end ``numerics`` and the rest
    ``length``; #12 (dense) or #13 (paged) launches 12 times for each
    decode step the engine completed on the fused rung, #11 12 times a
    prefill launch, #3 72 times a decode step and a prefill launch; the
    paged tokens and finish reasons equal the dense ones for every request
    (the prompts share one bucket, so both engines seat request i in slot
    i and the slot-keyed NaN faults hit the same requests) and every page
    comes back.  Each rung's decode ms/step is printed (readings, not
    gates).  Returns the launch counts of the two runs."""
    from repro_torch.infer import MonitorConfig
    from repro_torch.train import FaultPlan
    cfg, model, params = serve_model(torch, dev, seed)
    prompts = ladder_prompts(cfg, seed)[:SERVE_LADDER_REQUESTS]
    total, tokens = {}, {}
    for paged in (False, True):
        label = f"phase 17c {'paged' if paged else 'dense'}"
        eng = _serve_ladder_engine(
            dev, seed, model, params, POLICY, paged,
            monitor=MonitorConfig(reprobe_after=SERVE_LADDER_REPROBE))
        plan = FaultPlan.parse(SERVE_LADDER_PLAN)
        eng.fault_hooks = plan.engine_hooks()
        out, counts, wall = _serve_counted(torch, eng, prompts, label)
        s = eng.resilience_summary()
        st = eng.stats
        walk = serve_walk(s)
        by_rung = st["rung_steps"]
        attn = "decode_attention_paged" if paged else "decode_attention"
        want = _expect(int8_matmul=6 * cfg.n_layers * (st["prefill_calls"]
                                                       + st["decode_steps"]),
                       flash_attention_fwd_q8=cfg.n_layers
                       * st["prefill_calls"],
                       **{attn: cfg.n_layers * by_rung["fused"]})
        reasons = sorted(r.finish_reason for r in out)
        quarantined = [r.request_id for r in out
                       if r.finish_reason == "numerics"]
        print(f"{label}: {len(out)} requests, plan {plan.describe()}, fired "
              f"{plan.fired}; walk {walk}; kernel_errors "
              f"{s['kernel_errors']}, quarantined requests {quarantined}, "
              f"finish reasons {reasons}; decode steps {s['decode_steps']} "
              f"(by rung {by_rung}); in {wall:.3f} s; launch counts "
              f"{counts}")
        print(f"{label}: decode ms/step by rung on {card_line()}: "
              + ", ".join(f"{r} {1e3 * st['rung_s'][r] / max(n, 1):.2f} "
                          f"({n} steps)" for r, n in by_rung.items()))
        if walk != SERVE_LADDER_EXPECT:
            fail(f"{label}: walk {walk} != SERVE_LADDER_EXPECT "
                 f"{SERVE_LADDER_EXPECT}")
        if s["kernel_errors"] != 2 or reasons != (
                ["length"] * (len(out) - 2) + ["numerics"] * 2):
            fail(f"{label}: kernel_errors {s['kernel_errors']}, finish "
                 f"reasons {reasons}")
        for r in out:
            if r.finish_reason == "length" and len(r.tokens) != SERVE_NEW:
                fail(f"{label}: request {r.request_id}: {len(r.tokens)} "
                     f"tokens")
        if sum(by_rung.values()) != s["decode_steps"] or not all(
                by_rung.values()):
            fail(f"{label}: decode steps by rung {by_rung} of "
                 f"{s['decode_steps']}")
        if counts != want or not counts["flash_attention_fwd_q8"]:
            fail(f"{label}: launches {counts}, expected {want}")
        if paged and (eng.pool.free_pages != eng.n_pages - 1
                      or eng.pool.live_pages):
            fail(f"{label}: pages kept after the run: {eng.pool.free_pages} "
                 f"free of {eng.n_pages - 1}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        tokens[paged] = [(r.finish_reason, r.tokens) for r in out]
    bad = [i for i, (a, b) in enumerate(zip(tokens[True], tokens[False]))
           if a != b]
    if bad:
        fail(f"phase 17c: paged tokens or finish reasons differ from dense "
             f"in requests {bad}")
    print(f"phase 17c: paged tokens and finish reasons equal to dense for "
          f"all {len(prompts)} requests")
    return total


def serve_oom(torch, dev, seed):
    """Phase 17d: ``SERVE_OOM_PLAN`` on the paged engine (``POLICY``,
    pages of 64, the default pool): 16 requests whose prompts of 246 and
    245 tokens need their fifth page at decode steps 10 and 11, while the
    plan holds every free page (steps 10-12).  At least one preemption,
    never a ``CapacityError``; every request to length, every page back."""
    import numpy as np
    from repro_torch.train import FaultPlan
    cfg, model, params = serve_model(torch, dev, seed)
    rng = np.random.RandomState(seed + 4)
    prompts = [rng.randint(0, cfg.vocab_size, 246 - i % 2).tolist()
               for i in range(16)]
    eng = _serve_ladder_engine(dev, seed, model, params, POLICY, True)
    plan = FaultPlan.parse(SERVE_OOM_PLAN)
    eng.fault_hooks = plan.engine_hooks()
    out, _, wall = _serve_counted(torch, eng, prompts, "phase 17d")
    bad = [(r.request_id, len(r.tokens), r.finish_reason) for r in out
           if len(r.tokens) != SERVE_NEW or r.finish_reason != "length"]
    print(f"phase 17d: {plan.describe()} on the paged engine, 16 requests "
          f"of 245-246 prompt tokens: {len(out)} served in {wall:.3f} s, "
          f"fired {plan.fired}, preemptions {eng.preemptions}, pages free "
          f"after {eng.pool.free_pages}/{eng.n_pages - 1}")
    if bad or plan.fired != [SERVE_OOM_PLAN]:
        fail(f"phase 17d: requests not served to length {bad}, fired "
             f"{plan.fired}")
    if eng.preemptions < 1:
        fail("phase 17d: the drained pool preempted nothing")
    if eng.pool.free_pages != eng.n_pages - 1 or eng.pool.live_pages:
        fail(f"phase 17d: pages kept after the run: {eng.pool.free_pages} "
             f"free of {eng.n_pages - 1}")
    healthy(eng, "phase 17d")


# ---------------------------------------------------------------------------
# phase 18: llama pre-training at Yi-6B's width, with recomputation
# ---------------------------------------------------------------------------

#: phase 18a: 8 of Yi-6B's 32 layers (the full depth needs more than one 80 GB
#: card: FSDP, ROADMAP section 1, item 8; the depth and the steps cut to hold
#: the script's time budget, PERF.md section 4), 2 x 4096 tokens a step, 5
#: steps; 18b and 18c at 4 layers; 18c's second run 2 steps of 18a's shape
#: under ``_attend``; 18d card against CPU at 2 layers, 1 x 128 tokens
YI_TRAIN_LAYERS, YI_TRAIN_BATCH, YI_TRAIN_SEQ, YI_TRAIN_STEPS = 8, 2, 4096, 5
YI_REMAT_LAYERS, YI_XLA_STEPS = 4, 2
YI_CHECK_LAYERS, YI_CHECK_BATCH, YI_CHECK_SEQ = 2, 1, 128
#: phase 18c: ``_attend`` in q-chunks against one block at 4 layers x 1 x
#: 4096 tokens, ``TRAIN_POLICY``: limits on |d ce| and the gradients'
#: relative L2 distance, set from the readings at seeds 0-3 recorded in
#: PERF.md (``tools/yi_train_readings.py``).  The forward repeats its bits
#: (|d ce| read 0 at every seed), so ce is held bit for bit.  The backward
#: adds the chunks' dk and dv in bf16, one chunk at a time, where one
#: block rounds each sum once (the reference's scan does the same), and
#: the int8 gradient codecs carry those last bits into whole steps: the
#: gradients read 3.29e-2 to 3.86e-2, held to 6e-2.
YI_CHUNK_LIMITS = {"ce": 0.0, "grads": 6e-2}
#: phase 18d: the card against the CPU for one train step at Yi-6B's width
#: and 2 layers, set from the readings at seeds 0-3 recorded in PERF.md
#: (``tools/yi_train_readings.py``; not sized at run time).  Phase 8's
#: ``TRAIN_LIMITS`` hold but for two: |d ce| read 1.1e-4 to 5.1e-3 (its
#: limit 1e-3) and the updates where the sign agrees 1.57e-2 to 2.09e-2
#: (2e-2).  The bf16-carrier control read grads 6.34e-2 to 6.42e-2, sign
#: flips 1.104e-2 to 1.109e-2, updates 0.2313 to 0.2321 and updates where
#: the sign agrees 2.795e-2 to 2.843e-2, each above its limit below; its
#: |d ce| (4.0e-3 to 9.7e-3) lies among the sound readings, so ce cannot
#: tell the two apart at this width and is held to 1e-2, twice the largest
#: sound reading, and left out of the control's check.
YI_TRAIN_LIMITS = dict(TRAIN_LIMITS, ce=1e-2, updates_sign=2.4e-2)
YI_CONTROL = ("grads", "sign_flips", "updates_sign", "updates")


def yi_train_cfg(layers, impl="flash_pallas", **kw):
    """Yi-6B's published widths (``configs/yi_6b.py``) at ``layers``
    layers, ``remat`` on (the config's default) unless ``kw`` says
    otherwise."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("yi-6b"), n_layers=layers,
                               attention_impl=impl, **kw)


def _yi_tokens(torch, dev, cfg, batch, seq):
    from repro_torch.data import SyntheticCorpus
    return torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=batch, seq_len=seq)).to(dev)


def _loss_and_grads(torch, cfg, params, toks, policy=TRAIN_POLICY):
    """(ce, flat gradients, launch counts, peak bytes above the allocation
    before the step) of one forward and backward of ``policy``."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.train.step import value_and_grad
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss, _, grads = value_and_grad(build_model(cfg), policy, params,
                                    toks if isinstance(toks, dict)
                                    else {"tokens": toks})
    torch.cuda.synchronize()
    return (loss, tree_flatten(grads)[0], kernels.launch_counts(),
            torch.cuda.max_memory_allocated() - base)


@contextlib.contextmanager
def one_block_attend(seq):
    """``_attend`` in one block up to ``seq`` query rows: the score budget
    lifted and ``MAX_DENSE_Q`` raised to ``seq`` (``_pick_chunk`` never
    takes more rows than that), both restored after."""
    from repro_torch.models import attention
    saved = attention.SCORE_BUDGET_BYTES, attention.MAX_DENSE_Q
    attention.SCORE_BUDGET_BYTES, attention.MAX_DENSE_Q = float("inf"), seq
    try:
        yield
    finally:
        attention.SCORE_BUDGET_BYTES, attention.MAX_DENSE_Q = saved


def _grads_distance(torch, a, b):
    """|d ce|, the gradients' relative L2 distance, and whether ce and
    every gradient are bit-identical, of two ``_loss_and_grads``."""
    same = torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    return abs(float(a[0]) - float(b[0])), _rel_l2(torch, a[1], b[1]), same


def train_yi(torch, dev, seed):
    """Phase 18a: Yi-6B pre-training on the card -- ``YI_TRAIN_LAYERS``
    layers at full width, ``YI_TRAIN_BATCH`` x ``YI_TRAIN_SEQ`` tokens a
    step, ``flash_pallas``, recomputation on, ``TRAIN_POLICY`` with int
    moments, random weights from ``seed``: phase 7's checks and numbers
    (``train``), the launches a step exactly ``train_launches``: 14 #3 a
    layer (each of the 7 linears again in the backward), 7 #4 and 7 #5 a
    layer, one #6, 2 #8 a layer (the forward, and again in the
    recomputation) and one #9 and #10.  Returns the launch counts."""
    return train(torch, dev, seed, cfg=yi_train_cfg(YI_TRAIN_LAYERS),
                 batch=YI_TRAIN_BATCH, seq=YI_TRAIN_SEQ,
                 steps=YI_TRAIN_STEPS, tag="phase 18a train_yi")


def yi_remat(torch, dev, seed):
    """Phase 18b: at ``YI_REMAT_LAYERS`` layers and 18a's tokens, one
    forward and backward with recomputation on and one with it off, from
    the same weights: ce and every gradient bit-identical, the peak
    (above the weights) lower with recomputation; the launches of each."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = yi_train_cfg(YI_REMAT_LAYERS)
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, YI_TRAIN_BATCH, YI_TRAIN_SEQ)
    on = _loss_and_grads(torch, cfg, params, toks)
    off = _loss_and_grads(torch, dataclasses.replace(cfg, remat=False),
                          params, toks)
    d_ce, g_rel, same = _grads_distance(torch, on, off)
    show = lambda c: {k: v for k, v in c.items() if v}
    print(f"phase 18b: {cfg.name} {cfg.n_layers}L, {YI_TRAIN_BATCH} x "
          f"{YI_TRAIN_SEQ} tokens, flash_pallas: ce {float(on[0]):.6f} "
          f"(remat on) vs {float(off[0]):.6f} (off); ce and all "
          f"{len(on[1])} gradients "
          f"{'bit-identical' if same else 'DIFFER'} (tol 0; |d ce| "
          f"{d_ce:.3e}, grads rel L2 {g_rel:.3e}); peak above the weights "
          f"{on[3] / 2 ** 30:.2f} GiB with recomputation, "
          f"{off[3] / 2 ** 30:.2f} GiB without; launches on {show(on[2])}, "
          f"off {show(off[2])}")
    want_on, want_off = (train_launches(c) for c in
                         (cfg, dataclasses.replace(cfg, remat=False)))
    for got, want in ((on[2], want_on), (off[2], want_off)):
        want = dict(want, fused_adamw_leaves=0)
        if got != want:
            fail(f"phase 18b: launches {show(got)}, expected {show(want)}")
    if not same:
        fail("phase 18b: recomputation changed ce or a gradient")
    if not on[3] < off[3]:
        fail("phase 18b: the peak is not lower with recomputation")


def yi_attend_chunks(torch, dev, seed):
    """Phase 18c: ``_attend`` in q-chunks on the card.  At
    ``YI_REMAT_LAYERS`` layers and 1 x 4096 tokens the fp32 score slab of
    one block is 2.1 GB, so ``_pick_chunk`` takes chunks of 1024 rows;
    the same step under ``one_block_attend`` runs one block.  ce and every
    gradient within ``YI_CHUNK_LIMITS``, and the same pair under ``*=fp``
    printed beside them.  Then 18a's shape under ``attention_impl="xla"`` for
    ``YI_XLA_STEPS`` finite steps (chunks of 512 rows at B = 2), phase 7's
    checks.  Returns that run's launch counts."""
    from repro_torch.models import build_model
    from repro_torch.train.step import recompute_desc
    gc.collect()
    torch.cuda.empty_cache()
    cfg = yi_train_cfg(YI_REMAT_LAYERS, impl="xla")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, 1, YI_TRAIN_SEQ)
    chunked_desc = recompute_desc(cfg, 1, YI_TRAIN_SEQ)
    chunked = _loss_and_grads(torch, cfg, params, toks)
    with one_block_attend(YI_TRAIN_SEQ):
        block_desc = recompute_desc(cfg, 1, YI_TRAIN_SEQ)
        block = _loss_and_grads(torch, cfg, params, toks)
    d_ce, g_rel, same = _grads_distance(torch, chunked, block)
    lim = YI_CHUNK_LIMITS
    print(f"phase 18c: {cfg.name} {cfg.n_layers}L, 1 x {YI_TRAIN_SEQ} tokens, "
          f"xla: {chunked_desc} against {block_desc}: ce "
          f"{float(chunked[0]):.6f} vs {float(block[0]):.6f} (|d| "
          f"{d_ce:.3e}, limit {lim['ce']:.0e}), grads rel L2 {g_rel:.3e} "
          f"(limit {lim['grads']:.0e}), "
          f"{'bit-identical' if same else 'not bit-identical'}; peak above "
          f"the weights {chunked[3] / 2 ** 30:.2f} GiB chunked, "
          f"{block[3] / 2 ** 30:.2f} GiB in one block")
    if (chunked_desc, block_desc) != ("remat=layer+ce attend=q1024",
                                      "remat=layer+ce attend=dense"):
        fail(f"phase 18c: {chunked_desc} / {block_desc}")
    del chunked, block
    # where the distance comes from: the same pair under *=fp, whose
    # gradients carry the bf16 sums' last bits without int8 codecs
    fp = [_loss_and_grads(torch, cfg, params, toks, policy="*=fp")]
    with one_block_attend(YI_TRAIN_SEQ):
        fp.append(_loss_and_grads(torch, cfg, params, toks, policy="*=fp"))
    fp_ce, fp_rel, fp_same = _grads_distance(torch, *fp)
    print(f"phase 18c: the same pair under *=fp (no limit; where the "
          f"distance comes from): |d ce| {fp_ce:.3e}, grads rel L2 "
          f"{fp_rel:.3e}, {'bit-identical' if fp_same else 'not bit-identical'}")
    if not (d_ce <= lim["ce"] and g_rel <= lim["grads"]):
        fail("phase 18c: _attend in q-chunks out of limits")
    del params, fp
    return train(torch, dev, seed,
                 cfg=yi_train_cfg(YI_TRAIN_LAYERS, impl="xla"),
                 batch=YI_TRAIN_BATCH, seq=YI_TRAIN_SEQ, steps=YI_XLA_STEPS,
                 tag="phase 18c train_yi_xla", profile=False)


def yi_train_card_vs_cpu(torch, dev, seed, strict=True):
    """Phase 18d: phase 8's checks for one train step at Yi-6B's width and
    ``YI_CHECK_LAYERS`` layers (float32 carrier, recomputation on, 1 x 128
    tokens) within ``YI_TRAIN_LIMITS``, C's moments compared where the
    zero points agree and dequantized (``zero_points=False``), and D, the
    bf16-carrier control, above the limits of ``YI_CONTROL``."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = yi_train_cfg(YI_CHECK_LAYERS, dtype="float32")
    return train_card_vs_cpu(torch, dev, seed, cfg=cfg, batch=YI_CHECK_BATCH,
                             seq=YI_CHECK_SEQ, limits=YI_TRAIN_LIMITS,
                             label="phase 18d", control=YI_CONTROL,
                             zero_points=False, strict=strict)


# ---------------------------------------------------------------------------
# phase 22: pre-training the MoE family (Granite-3.0-MoE at full width and
# depth), with the expert-batched #4 and #5
# ---------------------------------------------------------------------------

#: phase 22a: the expert-batched #4 and #5 at each MoE model's experts --
#: (tag, E, the (K, N) of w_gate and w_up, then w_down, the rows an expert):
#: Granite's 40 experts at training's C = 2,049 (8,192 tokens x 8 / 40 x
#: 1.25, + 1), at 17 and at a ragged 1,001; Phi-3.5-MoE's 16 at 2,561 (a
#: 16,384-token chunk's capacity)
EXPERT_BWD_CASES = (("granite", 40, ((1536, 512), (512, 1536)),
                     (2049, 17, 1001)),
                    ("phi3.5-moe", 16, ((4096, 6400), (6400, 4096)), (2561,)))
#: phase 22b: Granite-3.0-MoE pre-training at full width and
#: ``GRANITE_TRAIN_LAYERS`` of its 32 layers (cut, with a step, to hold the
#: script's time budget, PERF.md section 4), 2 x 4096 tokens a step; 22c at 4
#: layers; 22d card vs CPU at 2 layers, 4 x 128 tokens (at 1 x 128 a sound
#: reading crossed its limit at seed 11: four sequences average the chaos a
#: random model's int8 codecs add to the readings, and the sound ones and the
#: control's move apart)
GRANITE_TRAIN_BATCH, GRANITE_TRAIN_SEQ, GRANITE_TRAIN_STEPS = 2, 4096, 5
GRANITE_TRAIN_LAYERS = 16
GRANITE_REMAT_LAYERS = 4
GRANITE_CHECK_LAYERS, GRANITE_CHECK_BATCH, GRANITE_CHECK_SEQ = 2, 4, 128
#: phase 22d: the card against the CPU for one train step at Granite's
#: width and 2 layers on the card's routes, set from the readings at seeds
#: 0-11 recorded in PERF.md (``tools/moe_train_readings.py``; H100 80GB
#: HBM3, 700 W; not sized at run time): each limit the geometric mean, to
#: two digits, of the largest sound reading (the card, and the plain
#: versions on the card, against the CPU) and the bf16-carrier control's
#: smallest -- grads 3.094e-2 against 4.760e-2, sign flips 8.375e-3
#: against 1.442e-2, updates where the sign agrees 2.265e-2 against
#: 2.657e-2, updates 0.1617 against 0.2180.  |d ce| read 4.4e-5 to 9.2e-4,
#: the control's 1.1e-4 to 2.1e-3: ce cannot tell the two apart at this
#: width (as at Yi's, phase 18d), so it is held to 5e-3 and left out of
#: the control's check
GRANITE_TRAIN_LIMITS = {"ce": 5e-3, "grads": 3.8e-2, "sign_flips": 1.1e-2,
                        "updates_sign": 2.5e-2, "updates": 0.19}
GRANITE_CONTROL = ("grads", "sign_flips", "updates_sign", "updates")


def granite_train_cfg(layers, **kw):
    """Granite-3.0-MoE's published widths (``configs/granite_moe_3b_a800m.py``:
    40 experts of 512, top 8, capacity factor 1.25) at ``layers`` layers,
    ``flash_pallas``, ``remat`` on (the config's default) unless ``kw``
    says otherwise."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               n_layers=layers,
                               **{"attention_impl": "flash_pallas", **kw})


def _int_mm_padded(torch, a, b):
    """``torch._int_mm`` on a (M, K) and b (K, N), the contraction and the
    rows zero-padded to what it takes (M > 16, K a multiple of 8): the
    padding made here, outside the timed calls."""
    m, k = a.shape
    kp, mp = -(-k // 8) * 8, max(m, 17)
    a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    b = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    return a.contiguous(), b.contiguous()


def check_int8_bwd_experts(torch, dev, gen, results):
    """Phase 22a, the expert-batched #4 (``int8_matmul_nt_experts``) and
    #5 (``int8_matmul_tn_experts``) at ``EXPERT_BWD_CASES``, bf16 gradient
    and output: one launch each bit for bit against its plain version (the
    2-D plain version expert by expert), against E launches of the 2-D
    entry, and against a second launch of itself; each timed queued and
    call by call beside its bound (bytes and int8 operations), its plain
    version and E ``torch._int_mm`` calls on the same int8 operands,
    queued; every GEMM kernel of the library holds ``IGMMA``."""
    import importlib
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    dt = torch.bfloat16
    rows = {"int8_matmul_nt_experts": [], "int8_matmul_tn_experts": []}
    for tag, e, kns, cs_rows in EXPERT_BWD_CASES:
        for k, n in kns:
            for c in cs_rows:
                g = (torch.randn((e, c, n), generator=gen, device=dev)
                     * 0.02).to(dt)
                w = torch.randint(-128, 128, (e, k, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                x = torch.randint(-128, 128, (e, c, k), generator=gen,
                                  device=dev, dtype=torch.int8)
                fw = torch.rand((e, 1, n), generator=gen, device=dev) \
                    * 0.01 + 1e-4
                fx = torch.rand((e, c, 1), generator=gen, device=dev) \
                    * 0.05 + 1e-4
                qn = _grad_scale(torch, g, fw, 2)
                qt = _grad_scale(torch, g, fx, 1)
                hn = torch.stack([im._quant_grad(g[i], fw[i],
                                                 im.scale_guard(qn[i]))
                                  for i in range(e)]).to(torch.int8)
                ht = torch.stack([im._quant_grad(g[i], fx[i],
                                                 im.scale_guard(qt[i]))
                                  for i in range(e)]).to(torch.int8)
                yard = {"int8_matmul_nt_experts": [
                            _int_mm_padded(torch, hn[i], w[i].t())
                            for i in range(e)],
                        "int8_matmul_tn_experts": [
                            _int_mm_padded(torch, x[i].t(), ht[i])
                            for i in range(e)]}
                del hn, ht
                cases = {
                    "int8_matmul_nt_experts": (
                        lambda: im.int8_matmul_nt_experts(g, w, fw, qn, dt),
                        lambda: im.int8_matmul_nt_experts_plain(g, w, fw, qn,
                                                                dt),
                        lambda: torch.stack([im.int8_matmul_nt(
                            g[i], w[i], fw[i], qn[i], dt) for i in range(e)]),
                        e * (2 * c * n + k * n + 4 * (n + c) + 2 * c * k),
                        im.gemm_splits(c, k, n, e)),
                    "int8_matmul_tn_experts": (
                        lambda: im.int8_matmul_tn_experts(x, g, fx, qt, dt),
                        lambda: im.int8_matmul_tn_experts_plain(x, g, fx, qt,
                                                                dt),
                        lambda: torch.stack([im.int8_matmul_tn(
                            x[i], g[i], fx[i], qt[i], dt) for i in range(e)]),
                        e * (c * k + 2 * c * n + 4 * (c + n) + 2 * k * n),
                        im.gemm_splits(k, n, c, e))}
                for name, (kern, plain, per, nbytes, splits) in cases.items():
                    want, got, again, by_2d = plain(), kern(), kern(), per()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    if not (torch.equal(got, want) and torch.equal(again, got)
                            and torch.equal(by_2d, got)):
                        fail(f"phase 22a {name} {tag} E={e} C={c} K={k} "
                             f"N={n}: not bit-exact against the plain "
                             f"version (max err {err}), a repeat or {e} 2-D "
                             f"launches")
                    del want, got, again, by_2d
                    b, by = bound_ms(nbytes, 2.0 * e * c * n * k, INT8_OPS)
                    ops = yard[name]
                    row = dict(
                        shape=f"E={e},C={c},K={k},N={n},bfloat16", model=tag,
                        splits=splits, max_abs_err=err, ms=queued_ms(kern),
                        ms_call=time_ms(kern),
                        plain_ms=time_ms(plain, iters=2, warmup=1),
                        bound_ms=b, bound_by=by,
                        library_ms=queued_ms(lambda: [torch._int_mm(a, bb)
                                                      for a, bb in ops]),
                        library=f"{e} x torch._int_mm on the int8 operands")
                    rows[name].append(row)
                    print(f"phase 22a {name} {tag} E={e} C={c:5d} K={k:5d} "
                          f"N={n:5d} bf16: bit-exact (tol 0) against the "
                          f"plain version, a repeat and {e} 2-D launches, "
                          f"{splits} split{'s' if splits > 1 else ''}; "
                          f"queued ms {row['ms']:.4f} (call by call "
                          f"{row['ms_call']:.4f}), plain_ms "
                          f"{row['plain_ms']:.4f}, bound_ms {b:.5f} ({by}), "
                          f"library_ms ({row['library']}, queued) "
                          f"{row['library_ms']:.4f}", flush=True)
                del g, w, x, fw, fx, qn, qt, yard, cases
    # the JSON entries report Granite's w_gate / w_up at training's C =
    # 2,049 (two of every three launches); kernels.json keeps all
    for name, line in (("int8_matmul_nt_experts", 146),
                       ("int8_matmul_tn_experts", 205)):
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/int8_matmul_bwd.cu",
            replaces=f"src/repro/kernels/int8_matmul.py:{line}", tol=0.0,
            shapes=rows[name], **rows[name][0])
    counts = sass_counts("int8_matmul_bwd", "IGMMA")
    gemm = {fn: c for fn, c in counts.items() if "gemm_s8_kernel" in fn}
    if not gemm or min(gemm.values()) == 0:
        fail(f"phase 22a: an int8 backward GEMM kernel has no IGMMA: {gemm}")
    print(f"phase 22a int8_matmul_bwd SASS: {len(gemm)} GEMM kernels, each "
          f"{min(gemm.values())}-{max(gemm.values())} IGMMA instructions")


def train_granite(torch, dev, seed):
    """Phase 22b: Granite-3.0-MoE pre-training on the card at its full
    width and ``GRANITE_TRAIN_LAYERS`` layers, ``GRANITE_TRAIN_BATCH`` x
    ``GRANITE_TRAIN_SEQ`` tokens a step, ``flash_pallas``, recomputation
    on, ``TRAIN_POLICY`` with int moments, random weights from ``seed``:
    phase 7's checks and numbers (``train``), the launches a step exactly
    ``train_launches``: 8 #3 a layer (the attention's 4 linears, twice), 6
    expert-batched #3 (gate, up, down, twice), 4 #4 and #5, 3
    expert-batched #4 and #5, 2 #8, one #9 and #10, and one #6 -- no
    per-expert 2-D launch.  Returns the launch counts."""
    cfg = granite_train_cfg(GRANITE_TRAIN_LAYERS)
    return train(torch, dev, seed, cfg=cfg,
                 batch=GRANITE_TRAIN_BATCH, seq=GRANITE_TRAIN_SEQ,
                 steps=GRANITE_TRAIN_STEPS, tag="phase 22b train_granite")


def granite_remat(torch, dev, seed):
    """Phase 22c: at ``GRANITE_REMAT_LAYERS`` layers and 22b's tokens, one
    forward and backward with recomputation on, one with it off and the
    first again, from the same weights: ce and every gradient
    bit-identical all three ways (the recomputation routes as the forward
    did, or the step raises: ``models/moe.route_check_contexts``), the
    peak (above the weights) lower with recomputation; the launches of
    each exactly ``train_launches``."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = granite_train_cfg(GRANITE_REMAT_LAYERS)
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, GRANITE_TRAIN_BATCH, GRANITE_TRAIN_SEQ)
    on = _loss_and_grads(torch, cfg, params, toks)
    off_cfg = dataclasses.replace(cfg, remat=False)
    off = _loss_and_grads(torch, off_cfg, params, toks)
    again = _loss_and_grads(torch, cfg, params, toks)
    d_ce, g_rel, same = _grads_distance(torch, on, off)
    repeat = _grads_distance(torch, on, again)[2]
    show = lambda c: {k: v for k, v in c.items() if v}
    print(f"phase 22c: {cfg.name} {cfg.n_layers}L, {GRANITE_TRAIN_BATCH} x "
          f"{GRANITE_TRAIN_SEQ} tokens, flash_pallas: ce {float(on[0]):.6f} "
          f"(remat on) vs {float(off[0]):.6f} (off); ce and all "
          f"{len(on[1])} gradients {'bit-identical' if same else 'DIFFER'} "
          f"(tol 0; |d ce| {d_ce:.3e}, grads rel L2 {g_rel:.3e}); a second "
          f"run with remat on {'bit-identical' if repeat else 'DIFFERS'}; "
          f"peak above the weights {on[3] / 2 ** 30:.2f} GiB with "
          f"recomputation, {off[3] / 2 ** 30:.2f} GiB without; launches on "
          f"{show(on[2])}, off {show(off[2])}")
    for got, c in ((on[2], cfg), (off[2], off_cfg), (again[2], cfg)):
        want = dict(train_launches(c), fused_adamw_leaves=0)
        if got != want:
            fail(f"phase 22c: launches {show(got)}, expected {show(want)}")
    if not (same and repeat):
        fail("phase 22c: recomputation or a repeat changed ce or a gradient")
    if not on[3] < off[3]:
        fail("phase 22c: the peak is not lower with recomputation")


def granite_train_card_vs_cpu(torch, dev, seed, strict=True, extra=None):
    """Phase 22d: phase 8's checks for one train step at Granite's width
    and ``GRANITE_CHECK_LAYERS`` layers (float32 carrier, recomputation on,
    ``flash_pallas``, ``GRANITE_CHECK_BATCH`` x ``GRANITE_CHECK_SEQ``
    tokens) on the card's routes, within ``GRANITE_TRAIN_LIMITS``: C's
    moments compared where the zero points agree and dequantized
    (``zero_points=False``), D, the bf16-carrier control, above the limits
    of ``GRANITE_CONTROL``, and E, every kernel's plain version on the
    card, within them (``train_card_vs_cpu``)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = granite_train_cfg(GRANITE_CHECK_LAYERS, dtype="float32")
    return train_card_vs_cpu(torch, dev, seed, cfg=cfg,
                             batch=GRANITE_CHECK_BATCH, seq=GRANITE_CHECK_SEQ,
                             limits=GRANITE_TRAIN_LIMITS, label="phase 22d",
                             control=GRANITE_CONTROL, zero_points=False,
                             strict=strict, plain_check=True, extra=extra)


# ---------------------------------------------------------------------------
# Phases 23 and 24: the SSM family, Mamba2-130M served and pre-trained at
# its published widths and full depth
# ---------------------------------------------------------------------------

#: phase 23a: #3's (K, N) in a Mamba2-130M layer -- in_z and in_x (768,
#: 1536), in_bc (768, 256), in_dt (768, 24: the first output width on any
#: path that is no multiple of 16) and out_proj (1536, 768) -- at the
#: decode step's 16 slots, the second wave's prefill (16 x 256 rows) and
#: the first wave's and a train step's 8,192 rows
MAMBA_INT8_KN = ((768, 1536), (768, 256), (768, 24), (1536, 768))
MAMBA_DECODE_KN = ((768, 1536), (768, 1536), (768, 256), (768, 24),
                   (1536, 768))
MAMBA_INT8_ROWS = (16, 4096, 8192)
#: the block linears of an SSM layer (its four input segments, out_proj)
SSM_LINEARS = 5
#: the linears of one invocation of the hybrid's shared block (wq, wk, wv,
#: wo, w_gate, w_up, w_down, proj)
HYBRID_SHARED_LINEARS = 8
#: phase 23c, policy B at Mamba2-130M's width and 2 layers: the geometric
#: mean, to two digits, of the card-vs-CPU readings' largest and the
#: bf16-carrier control's smallest at seeds 0-3 (``tools/ssm_readings.py``,
#: PERF.md; H100 80GB HBM3, 700 W): 9.5e-7 to 1.90e-2 against controls
#: 0.172-0.597.  The plain versions on the card read the same as the
#: kernels (the card with the plain int8_matmul in the kernel's place is
#: bit-identical at every seed): the distance is PyTorch's own fp32 ops on
#: the two devices, carried by the per-token codec.  Policy A reads 7.2e-6
#: to 3.6e-5 under phase 5's 1e-2, its controls 0.094-0.369.
MAMBA_B_LIMIT = 0.057
MAMBA = ServeCell("23", "mamba2", "mamba2-130m", MAMBA_INT8_KN,
                  MAMBA_DECODE_KN, None, None, slots=16, seq=2048,
                  requests=32, prompt=(129, 512), new=32,
                  b_limit=MAMBA_B_LIMIT, control=True,
                  waves=((257, 512), (129, 256)), rows=MAMBA_INT8_ROWS)
#: phase 24: Mamba2-130M pre-training at full width and depth, 4 x 2048
#: tokens a step (16 SSD chunks of 128 a row); 24d card vs CPU at 2 layers,
#: 2 x 256 tokens
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, MAMBA_TRAIN_STEPS = 4, 2048, 5
MAMBA_CHECK_LAYERS, MAMBA_CHECK_BATCH, MAMBA_CHECK_SEQ = 2, 2, 256
#: phase 24d: the card against the CPU for one train step at Mamba2-130M's
#: width and 2 layers, set from the readings at seeds 0-3
#: (``tools/ssm_readings.py``, PERF.md; H100 80GB HBM3, 700 W; not sized at
#: run time): each limit the geometric mean, to two digits, of the largest
#: sound reading (the card, and the plain versions on the card, which read
#: the same) and the bf16-carrier control's smallest -- grads 2.62e-2
#: against 7.39e-2, sign flips 2.43e-3 against 9.44e-3, updates where the
#: sign agrees 1.41e-2 against 3.67e-2, updates 7.12e-2 against 0.146
#: (phase 8's 1e-2 and 0.2 would hold the control inside two of them).
#: |d ce| read 1.4e-4 to 4.0e-4, the control's 5.3e-5 to 1.7e-3: ce cannot
#: tell the two apart, so it keeps phase 8's 1e-3 and stays out of the
#: control's check
MAMBA_TRAIN_LIMITS = {"ce": 1e-3, "grads": 4.4e-2, "sign_flips": 4.8e-3,
                      "updates_sign": 2.3e-2, "updates": 0.10}
MAMBA_CONTROL = ("grads", "sign_flips", "updates_sign", "updates")


def mamba_train_cfg(layers, **kw):
    """Mamba2-130M's published widths (``configs/mamba2_130m.py``) at
    ``layers`` layers, ``remat`` on (the config's default) unless ``kw``
    says otherwise."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-130m"), n_layers=layers,
                               **kw)


def check_int8_bwd_ssm(torch, dev, gen, results):
    """Phase 24a: #4 and #5 at the five projections' training shapes (M =
    8,192 tokens, bf16 gradients), phase 6a's gates and timings
    (``check_int8_bwd``): nt quantizes in_dt's gradient into pad16(24) =
    32 columns, tn writes a (768, 24) dW."""
    check_int8_bwd(torch, dev, gen, results,
                   cases=[(k, n, torch.bfloat16) for k, n in MAMBA_INT8_KN],
                   tag="mamba2", phase="24a")


def train_mamba2(torch, dev, seed):
    """Phase 24b: Mamba2-130M pre-training on the card at its full width
    and depth -- 24 layers, ``MAMBA_TRAIN_BATCH`` x ``MAMBA_TRAIN_SEQ``
    tokens a step, recomputation on (one checkpoint a layer),
    ``TRAIN_POLICY`` with int moments, random weights from ``seed``: phase
    7's checks and numbers (``train``), the launches a step exactly
    ``train_launches``: 240 #3 (the five projections x 24, again in the
    recomputation), 120 #4 and #5, one #6, and no attention kernel.
    Returns the launch counts."""
    return train(torch, dev, seed, cfg=mamba_train_cfg(24),
                 batch=MAMBA_TRAIN_BATCH, seq=MAMBA_TRAIN_SEQ,
                 steps=MAMBA_TRAIN_STEPS, tag="phase 24b train_mamba2")


def mamba_remat(torch, dev, seed):
    """Phase 24c: at full depth and 24b's tokens, one forward and backward
    with recomputation on, one with it off and the first again, from the
    same weights: ce and every gradient bit-identical all three ways, the
    peak (above the weights) lower with recomputation; the launches of
    each exactly ``train_launches``."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = mamba_train_cfg(24)
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ)
    on = _loss_and_grads(torch, cfg, params, toks)
    off_cfg = dataclasses.replace(cfg, remat=False)
    off = _loss_and_grads(torch, off_cfg, params, toks)
    again = _loss_and_grads(torch, cfg, params, toks)
    d_ce, g_rel, same = _grads_distance(torch, on, off)
    repeat = _grads_distance(torch, on, again)[2]
    show = lambda c: {k: v for k, v in c.items() if v}
    print(f"phase 24c: {cfg.name} {cfg.n_layers}L, {MAMBA_TRAIN_BATCH} x "
          f"{MAMBA_TRAIN_SEQ} tokens: ce {float(on[0]):.6f} (remat on) vs "
          f"{float(off[0]):.6f} (off); ce and all {len(on[1])} gradients "
          f"{'bit-identical' if same else 'DIFFER'} (tol 0; |d ce| "
          f"{d_ce:.3e}, grads rel L2 {g_rel:.3e}); a second run with remat "
          f"on {'bit-identical' if repeat else 'DIFFERS'}; peak above the "
          f"weights {on[3] / 2 ** 30:.2f} GiB with recomputation, "
          f"{off[3] / 2 ** 30:.2f} GiB without; launches on {show(on[2])}, "
          f"off {show(off[2])}")
    for got, c in ((on[2], cfg), (off[2], off_cfg), (again[2], cfg)):
        want = dict(train_launches(c), fused_adamw_leaves=0)
        if got != want:
            fail(f"phase 24c: launches {show(got)}, expected {show(want)}")
    if not (same and repeat):
        fail("phase 24c: recomputation or a repeat changed ce or a gradient")
    if not on[3] < off[3]:
        fail("phase 24c: the peak is not lower with recomputation")


def mamba_train_card_vs_cpu(torch, dev, seed, strict=True, extra=None):
    """Phase 24d: phase 8's checks for one train step at Mamba2-130M's
    width and ``MAMBA_CHECK_LAYERS`` layers (float32 carrier,
    recomputation on, ``MAMBA_CHECK_BATCH`` x ``MAMBA_CHECK_SEQ`` tokens)
    within ``MAMBA_TRAIN_LIMITS``: C's moments compared where the zero
    points agree and dequantized (``zero_points=False``), D, the
    bf16-carrier control, above the limits of ``MAMBA_CONTROL``, and E,
    every kernel's plain version on the card, within them
    (``train_card_vs_cpu``)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = mamba_train_cfg(MAMBA_CHECK_LAYERS, dtype="float32")
    return train_card_vs_cpu(torch, dev, seed, cfg=cfg,
                             batch=MAMBA_CHECK_BATCH, seq=MAMBA_CHECK_SEQ,
                             limits=MAMBA_TRAIN_LIMITS, label="phase 24d",
                             control=MAMBA_CONTROL, zero_points=False,
                             strict=strict, plain_check=True, extra=extra)


# ---------------------------------------------------------------------------
# Phase 25: the hybrid family, Zamba2-2.7B served at its published widths
# and full depth
# ---------------------------------------------------------------------------

#: phase 25a: #3's (K, N) in Zamba2-2.7B -- an SSM layer's in_z and in_x
#: (2560, 5120), in_bc (2560, 128), in_dt (2560, 80), out_proj (5120,
#: 2560); the shared block's wq, wk, wv and wo (5120, 5120), w_gate and
#: w_up (5120, 10240), w_down (10240, 5120) and proj (5120, 2560, as
#: out_proj) -- at the decode step's 16 slots, the second wave's prefill
#: and the first wave's (16 x 256 and 16 x 2048 rows: 4,096 and 32,768;
#: 2,048 stands for the first)
ZAMBA_INT8_KN = ((2560, 5120), (2560, 128), (2560, 80), (5120, 2560),
                 (5120, 5120), (5120, 10240), (10240, 5120))
ZAMBA_INT8_ROWS = (16, 2048, 4096)
#: an SSM layer's five projections and the shared block's eight linears,
#: each in call order
ZAMBA_SSM_KN = ((2560, 5120), (2560, 5120), (2560, 128), (2560, 80),
                (5120, 2560))
ZAMBA_SHARED_KN = ((5120, 5120),) * 4 + ((5120, 10240), (5120, 10240),
                                         (10240, 5120), (5120, 2560))
#: #11 at Zamba2's prefill: 2 prompts of 2048 over 4096-row buffers, 32
#: heads of 160, no grouping; #12 / #13 at 16 slots of 4096 rows, G = 1
ZAMBA_Q8_SHAPE = (2, 2048, 4096, 32, 32, 160)
ZAMBA_DECODE_SHAPE = (16, 4096, 32, 1, 160)
#: phase 25c, policy B at Zamba2's width and 12 layers (two groups: a cut
#: below ``hybrid_attn_every`` would drop the shared block): the geometric
#: mean, to two digits, of the card-vs-CPU readings' largest and the
#: bf16-carrier control's smallest at seeds 0-3 (``tools/hybrid_readings.py``,
#: PERF.md; H100 80GB HBM3, 700 W): 0.517-0.903 against controls
#: 2.47-4.05.  The plain versions on the card read 0.468-0.853 and the card
#: with the plain int8_matmul in the kernel's place is bit-identical at
#: every seed: the distance is PyTorch's own fp32 ops on the two devices,
#: carried through 12 layers of per-token activation codecs on a random
#: model (its stacked SSM weights at the true fan-in).  Policy A reads
#: 5.4e-4 to 7.9e-4 under phase 5's 1e-2, its controls 0.98-2.58.  Seeds
#: 4-7, read after the limit was set, give 0.451-1.060 against controls
#: 2.04-3.61.
ZAMBA_B_LIMIT = 1.5
#: phase 25b serves 24 of Zamba2's 54 layers (four groups; cut to hold the
#: script's time budget, PERF.md section 4)
ZAMBA_SERVE_LAYERS = 24
ZAMBA = ServeCell("25", "zamba2", "zamba2-2.7b", ZAMBA_INT8_KN, ZAMBA_SSM_KN,
                  ZAMBA_Q8_SHAPE, ZAMBA_DECODE_SHAPE, slots=16, seq=4096,
                  requests=32, prompt=(129, 2048), new=16,
                  b_limit=ZAMBA_B_LIMIT, control=True,
                  waves=((1025, 2048), (129, 256)), rows=ZAMBA_INT8_ROWS,
                  shared_kn=ZAMBA_SHARED_KN, cmp_layers=12,
                  layers=ZAMBA_SERVE_LAYERS)


# ---------------------------------------------------------------------------
# Phase 26: pre-training the hybrid family, Zamba2-2.7B at its published
# widths and full depth
# ---------------------------------------------------------------------------

#: phase 26a: #8, #9 and #10 at the shared block's training attention --
#: (B, S, heads, head dim), causal, bf16: above
#: ``FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM`` = 128 the backward runs
#: ``flash_bwd_sm90_wide.cu``; ``flash_attn.cu``'s CUDA-core bodies, which
#: it replaced on this path, are timed beside it on the same inputs
ZAMBA_FLASH_SHAPE = (2, 4096, 32, 160)
#: and at Gemma-2B's training attention: 8 query heads of 256 over one KV
#: head, repeated to 8 as ``models.attention._flash`` does (BH 16); on no
#: system path yet (Gemma's training is a later slice)
GEMMA_FLASH_SHAPE, GEMMA_FLASH_KV_HEADS = (2, 4096, 8, 256), 1
#: the plain versions' heads at a time at those shapes (a whole call's
#: float64 products would hold several (B * H, S, S) slabs at once)
ZAMBA_PLAIN_HEADS = 8
#: phase 26b: Zamba2-2.7B pre-training at full width and depth, 2 x 4096 tokens
#: a step; 26c the same under ``_attend`` at ``ZAMBA_XLA_LAYERS`` (cut to hold
#: the script's time budget); 26d remat at 12 layers (two groups: the shared
#: block's gradient sums two invocations); 26e card vs CPU at 12 layers, 1 x
#: 128 tokens
ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, ZAMBA_TRAIN_STEPS = 2, 4096, 5
ZAMBA_XLA_STEPS, ZAMBA_XLA_LAYERS = 2, 12
ZAMBA_REMAT_LAYERS = 12
ZAMBA_CHECK_LAYERS, ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ = 12, 1, 128
#: phase 26e: the card against the CPU for one train step at Zamba2's
#: width and 12 layers, set from the readings at seeds 0-7 recorded in
#: PERF.md (``tools/hybrid_train_readings.py``; H100 80GB HBM3, 700 W; not
#: sized at run time): each limit the geometric mean, to two digits, of the
#: largest sound reading (the card, and the plain versions on the card,
#: which read the same) and the bf16-carrier control's smallest -- grads
#: 0.540 against 0.737, sign flips 0.117 against 0.227, updates where the
#: sign agrees 7.17e-2 against 9.13e-2, updates 0.664 against 0.942.  The
#: sound readings are large: as in phase 25c, PyTorch's own last bits on
#: the two devices (the card with the plain versions reads as the card
#: does) are carried through 24 per-token activation codecs and the
#: gradient codecs of a random 12-layer model.  |d ce| read 4.3e-3 to
#: 1.6e-2, the control's 3.5e-3 to 7.0e-2: ce cannot tell the two apart,
#: so it is held to 4e-2, 2.5x the largest sound reading, and left out of
#: the control's check
ZAMBA_TRAIN_LIMITS = {"ce": 4e-2, "grads": 0.63, "sign_flips": 0.16,
                      "updates_sign": 8.1e-2, "updates": 0.79}
ZAMBA_CONTROL = ("grads", "sign_flips", "updates_sign", "updates")


def zamba_train_cfg(layers, **kw):
    """Zamba2-2.7B's published widths (``configs/zamba2_2p7b.py``) at
    ``layers`` layers (a multiple of ``hybrid_attn_every`` = 6),
    ``flash_pallas``, ``remat`` on (the config's default) unless ``kw``
    says otherwise."""
    return ZAMBA.config(n_layers=layers,
                        **{"attention_impl": "flash_pallas", **kw})


def check_flash_train(torch, dev, gen, results, tag, shape, kv_heads,
                      skv=None, causal=True, cuda_core=True, phase="26a"):
    """Phase 26a's attention at one training shape ``shape`` = (B, S,
    heads, head dim), ``kv_heads`` KV heads repeated to the query heads as
    ``_flash`` repeats them (``skv`` keys, default S, under ``causal``;
    phase 28a: the cross-attention, non-causal, Sq > Skv): #8, #9 and #10
    (bf16, unit-normal inputs) against their plain versions on the same
    inputs
    (``ZAMBA_PLAIN_HEADS`` heads a call; the backward's products summed in
    float64, the kernels' lse and delta given to both): o, dq, dk and dv
    within ``FLASH_BF16``, the LSE within ``FLASH_LSE_TOL``, a second
    launch bit-identical.  Each timed with the card's queue full beside its
    bound (phase 13's count: the bf16-exact products at 989 TFLOP/s, a
    product of fp32 p or ds as three), its plain version and SDPA's forward
    and backward at the same shape; #9 and #10 also beside
    ``flash_attn.cu``'s CUDA-core bodies at bf16 on the same inputs with
    ``cuda_core`` (what ran above head dim 128 before
    ``flash_bwd_sm90_wide.cu``; two calls each, 58-96 ms a call at Zamba2's
    shape).  Results go under ``results[name][tag]``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    b, s, h, hd = shape
    skv = skv or s
    bh, rep = b * h, h // kv_heads
    q, k, v, do = (torch.randn(shp, generator=gen, device=dev).bfloat16()
                   for shp in ((bh, s, hd), (b * kv_heads, skv, hd),
                               (b * kv_heads, skv, hd), (bh, s, hd)))
    if rep > 1:
        k, v = (t.repeat_interleave(rep, dim=0) for t in (k, v))
    got = _flash_all(fa, q, k, v, do, causal, 0)
    again = _flash_all(fa, q, k, v, do, causal, 0)
    repeat = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    c = ZAMBA_PLAIN_HEADS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    parts = [_flash_plain(fa, q[i:i + c], k[i:i + c], v[i:i + c],
                          do[i:i + c], got[1][i:i + c], got[5][i:i + c],
                          causal, 0) for i in range(0, bh, c)]
    want = [torch.cat(t) for t in zip(*parts)]
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    del parts
    lse_err = (got[1] - want[1]).abs().max().item()
    names = ("o", "dq", "dk", "dv")
    dist = [_bf16_distance(torch, g, w)
            for g, w in zip(got[:1] + got[2:5], want[:1] + want[2:])]
    diff = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got[:1] + got[2:5], want[:1] + want[2:])]
    lim = FLASH_BF16
    ok = (repeat and lse_err <= FLASH_LSE_TOL
          and all(d[0] <= lim["rel_l2"] and d[1] <= lim["over_ulp"]
                  for d in dist))
    bwd_src = fa.bwd_library(torch.bfloat16, hd) + ".cu"
    mask = "causal" if causal else "full"
    print(f"phase {phase} flash {tag} B={b} Sq={s} Skv={skv} H={h} "
          f"KV={kv_heads} hd={hd} {mask} bf16 against the plain versions "
          f"(backward on {bwd_src}): "
          + ", ".join(f"{n} rel L2 {d[0]:.2e}, over one bf16 step {d[1]:.2e}"
                      for n, d in zip(names, dist))
          + f" (limits {lim['rel_l2']:.0e}, {lim['over_ulp']:.0e}); lse max "
          f"err {lse_err:.2e} (tol {FLASH_LSE_TOL:.0e}); second launch "
          f"{'bit-identical' if repeat else 'DIFFERS'}")
    del want
    if not ok:
        fail(f"phase {phase}: a flash kernel disagrees with its plain "
             f"version at {tag}'s hd {hd}")
    o, lse, delta = got[0], got[1], got[5]
    bwd = (q, k, v, do, lse, delta)
    q4, do4 = (t.view(b, h, s, hd) for t in (q, do))
    k4, v4 = (t.view(b, h, skv, hd) for t in (k, v))
    sdpa_fwd = queued_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), iters=5)
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    sdpa_bwd = queued_ms(lambda: torch.autograd.grad(o4, leaves, do4,
                                                     retain_graph=True),
                         iters=5)
    del leaves, o4
    core = {"dkdv": None, "dq": None}
    for which, outs in (("dkdv", (torch.empty_like(k), torch.empty_like(v))),
                        ("dq", (torch.empty_like(q),))):
        if cuda_core:
            core[which] = queued_ms(
                lambda which=which, outs=outs: fa._launch_bwd(
                    which, *bwd, outs, causal, 0, library="flash_attn"),
                iters=2, warmup=1)
    pairs = _visible_pairs(s, skv, causal, 0) * bh
    # a q-side tensor (q, o, dO, dq) and a k-side one (k, v, dk, dv), bf16
    tq, tk, rows = bh * s * hd * 2, bh * skv * hd * 2, bh * s * 4
    mm = 2 * hd * pairs
    shape_s = (f"B={b},Sq={s},Skv={skv},H={h},KV={kv_heads},hd={hd},{mask}"
               if skv != s else f"B={b},S={s},H={h},KV={kv_heads},hd={hd},"
               f"{mask}")
    for name, kern, nbytes, ops, lib, lib_what, src, err, base in (
            ("flash_attention_fwd_lse",
             lambda: fa.flash_attention_fwd_lse(q, k, v, causal=causal),
             2 * tq + 2 * tk + rows, 2 * mm, sdpa_fwd, "SDPA forward",
             "flash_fwd_sm90.cu", max(diff[0], lse_err), None),
            ("flash_attention_bwd_dkdv",
             lambda: fa.flash_attention_bwd_dkdv(*bwd, causal=causal),
             2 * tq + 4 * tk + 2 * rows, 8 * mm, sdpa_bwd,
             "SDPA backward, dq+dk+dv together", bwd_src,
             max(diff[2], diff[3]), core["dkdv"]),
            ("flash_attention_bwd_dq",
             lambda: fa.flash_attention_bwd_dq(*bwd, causal=causal),
             3 * tq + 2 * tk + 2 * rows, 5 * mm, sdpa_bwd,
             "SDPA backward, dq+dk+dv together", bwd_src, diff[1],
             core["dq"])):
        ms = queued_ms(kern, iters=5)
        bd, by = bound_ms(nbytes, ops, BF16_FLOPS)
        was = ("" if base is None else
               f"; flash_attn.cu's CUDA-core body at bf16 on the same inputs "
               f"{base:.4f} (queued), {base / ms:.1f}x this kernel's time")
        print(f"phase {phase} {name} {tag} {shape_s} bf16: ms {ms:.4f} "
              f"(queued), "
              f"plain_ms {plain_ms:.4f} (the three plain versions in one "
              f"call), bound_ms {bd:.5f} ({by}; {ops / 1e9:.1f} GFLOP "
              f"bf16-exact at 989 TFLOP/s, {nbytes / 1e6:.1f} MB), "
              f"{ms / bd:.1f}x the bound, library_ms({lib_what}, queued) "
              f"{lib:.4f}, {ms / lib:.2f}x it; route "
              f"src/repro_torch/csrc/{src}{was}")
        results[name][tag] = dict(
            shape=shape_s, source=f"src/repro_torch/csrc/{src}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bd,
            bound_by=by, library_ms=lib,
            **({} if base is None else {"cuda_core_ms": base}))
    del q, k, v, do, got, o, lse, delta, bwd, q4, k4, v4, do4


def check_zamba_train_kernels(torch, dev, gen, results):
    """Phase 26a: #4 and #5 at Zamba2-2.7B's seven (K, N)
    (``ZAMBA_INT8_KN``: an SSM layer's projections, the shared block's
    attention, MLP and projection) at 8,192 rows, bf16, phase 6a's gates
    and timings (``check_int8_bwd``); then the attention's #8, #9 and #10
    at head dim 160 (``check_flash_train`` at ``ZAMBA_FLASH_SHAPE``) and at
    Gemma-2B's training attention, head dim 256 (``GEMMA_FLASH_SHAPE``)."""
    check_int8_bwd(torch, dev, gen, results,
                   cases=[(k, n, torch.bfloat16) for k, n in ZAMBA_INT8_KN],
                   tag="zamba2", phase="26a")
    check_flash_train(torch, dev, gen, results, "zamba2", ZAMBA_FLASH_SHAPE,
                      ZAMBA_FLASH_SHAPE[2])
    check_flash_train(torch, dev, gen, results, "gemma2b", GEMMA_FLASH_SHAPE,
                      GEMMA_FLASH_KV_HEADS)


def train_zamba2(torch, dev, seed):
    """Phase 26b: Zamba2-2.7B pre-training on the card at its full width
    and depth -- 54 layers, ``ZAMBA_TRAIN_BATCH`` x ``ZAMBA_TRAIN_SEQ``
    tokens a step, ``flash_pallas``, recomputation on (two segments a group, split at the
    shared block's attention context), ``TRAIN_POLICY`` with int moments,
    random weights from ``seed``: phase 7's checks and numbers (``train``),
    the launches a step exactly ``train_launches``: 684 #3 (5 x 54
    projections and 8 x 9 shared-block linears, again in the
    recomputation), 342 #4 and #5, one #6, 18 #8, 9 #9 and #10 -- #9 and
    #10 from the library ``bwd_library`` names at head dim 160, the
    tensor-core ``flash_bwd_sm90_wide``, and no other backward library
    (``libraries_loaded``).  Returns the launch counts."""
    from repro_torch.kernels import flash_attn as fa
    gc.collect()
    torch.cuda.empty_cache()
    cfg = zamba_train_cfg(54)
    with libraries_loaded() as loaded:
        counts = train(torch, dev, seed, cfg=cfg, batch=ZAMBA_TRAIN_BATCH,
                       seq=ZAMBA_TRAIN_SEQ, steps=ZAMBA_TRAIN_STEPS,
                       tag="phase 26b train_zamba2")
    want = fa.bwd_library(torch.bfloat16, cfg.head_dim)
    bwd = sorted(n for n in loaded if n in fa._BWD_ENTRY)
    print(f"phase 26b: #9/#10 ran on {bwd} (expected [{want!r}])")
    if want != "flash_bwd_sm90_wide" or bwd != [want]:
        fail(f"phase 26b: the backward ran on {bwd}, expected the "
             f"tensor-core flash_bwd_sm90_wide")
    return counts


def train_zamba2_xla(torch, dev, seed):
    """Phase 26c: 26b's step under ``attention_impl="xla"``, the
    reference's default (``_attend`` in checkpointed q-chunks), for
    ``ZAMBA_XLA_STEPS`` finite steps with no flash launch.  Returns the
    launch counts."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = zamba_train_cfg(ZAMBA_XLA_LAYERS, attention_impl="xla")
    return train(torch, dev, seed, cfg=cfg, batch=ZAMBA_TRAIN_BATCH,
                 seq=ZAMBA_TRAIN_SEQ, steps=ZAMBA_XLA_STEPS,
                 tag="phase 26c train_zamba2_xla", profile=False)


def zamba_remat(torch, dev, seed):
    """Phase 26d: at ``ZAMBA_REMAT_LAYERS`` layers (two groups, so the
    shared weights' gradients each sum two invocations) and 26b's tokens,
    one forward and backward with recomputation on, one with it off and
    the first again, from the same weights: ce and every gradient
    bit-identical all three ways, the peak (above the weights) lower with
    recomputation; the launches of each exactly ``train_launches``."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = zamba_train_cfg(ZAMBA_REMAT_LAYERS)
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ)
    on = _loss_and_grads(torch, cfg, params, toks)
    off_cfg = dataclasses.replace(cfg, remat=False)
    off = _loss_and_grads(torch, off_cfg, params, toks)
    again = _loss_and_grads(torch, cfg, params, toks)
    d_ce, g_rel, same = _grads_distance(torch, on, off)
    repeat = _grads_distance(torch, on, again)[2]
    show = lambda c: {k: v for k, v in c.items() if v}
    print(f"phase 26d: {cfg.name} {cfg.n_layers}L, {ZAMBA_TRAIN_BATCH} x "
          f"{ZAMBA_TRAIN_SEQ} tokens, flash_pallas: ce {float(on[0]):.6f} "
          f"(remat on) vs {float(off[0]):.6f} (off); ce and all "
          f"{len(on[1])} gradients {'bit-identical' if same else 'DIFFER'} "
          f"(tol 0; |d ce| {d_ce:.3e}, grads rel L2 {g_rel:.3e}); a second "
          f"run with remat on {'bit-identical' if repeat else 'DIFFERS'}; "
          f"peak above the weights {on[3] / 2 ** 30:.2f} GiB with "
          f"recomputation, {off[3] / 2 ** 30:.2f} GiB without; launches on "
          f"{show(on[2])}, off {show(off[2])}")
    for got, c in ((on[2], cfg), (off[2], off_cfg), (again[2], cfg)):
        want = dict(train_launches(c), fused_adamw_leaves=0)
        if got != want:
            fail(f"phase 26d: launches {show(got)}, expected {show(want)}")
    if not (same and repeat):
        fail("phase 26d: recomputation or a repeat changed ce or a gradient")
    if not on[3] < off[3]:
        fail("phase 26d: the peak is not lower with recomputation")


def zamba_train_card_vs_cpu(torch, dev, seed, strict=True, extra=None):
    """Phase 26e: phase 8's checks for one train step at Zamba2-2.7B's
    width and ``ZAMBA_CHECK_LAYERS`` layers (float32 carrier,
    recomputation on, ``flash_pallas``, ``ZAMBA_CHECK_BATCH`` x
    ``ZAMBA_CHECK_SEQ`` tokens, ``true_fan_in`` weights) within
    ``ZAMBA_TRAIN_LIMITS``: C's moments compared where the zero points
    agree and dequantized (``zero_points=False``), D, the bf16-carrier
    control, above the limits of ``ZAMBA_CONTROL``, and E, every kernel's
    plain version on the card, within them (``train_card_vs_cpu``)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = zamba_train_cfg(ZAMBA_CHECK_LAYERS, dtype="float32")
    return train_card_vs_cpu(torch, dev, seed, cfg=cfg,
                             batch=ZAMBA_CHECK_BATCH, seq=ZAMBA_CHECK_SEQ,
                             limits=ZAMBA_TRAIN_LIMITS, label="phase 26e",
                             control=ZAMBA_CONTROL, zero_points=False,
                             strict=strict, plain_check=True, extra=extra)


# ---------------------------------------------------------------------------
# phases 27 and 28: the encoder-decoder family (seamless-m4t-medium at full
# width and depth), served and pre-trained, with #7-#10 non-causal
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-medium"
#: phase 27b: 12 + 12 layers, 8 rows of 1,024 frames (``enc_len_for`` of a
#: 4,096-token sequence), a 64-token prompt, 32 new tokens
SEAMLESS_SERVE_BATCH, SEAMLESS_SERVE_SEQ = 8, 4096
SEAMLESS_PROMPT, SEAMLESS_NEW = 64, 32
#: phase 28a: 4 x 2,048 decoder tokens over 512 frames a step; 28b at 4 + 4
#: layers
SEAMLESS_TRAIN_BATCH, SEAMLESS_TRAIN_SEQ, SEAMLESS_TRAIN_STEPS = 4, 2048, 5
SEAMLESS_REMAT_LAYERS = 4
#: phases 27a and 28c: 2 + 2 layers at full width and vocab, float32; 27a
#: greedy-generates 8 tokens from 2 prompts of 64 tokens over 64 frames,
#: 28c trains one step on 2 x 128 tokens over 32 frames
SEAMLESS_CHECK_LAYERS = 2
SEAMLESS_CHECK_BATCH, SEAMLESS_CHECK_PROMPT = 2, 64
SEAMLESS_CHECK_FRAMES, SEAMLESS_CHECK_NEW = 64, 8
SEAMLESS_TRAIN_CHECK_BATCH, SEAMLESS_TRAIN_CHECK_SEQ = 2, 128
#: phase 27a: the limit on max |d logit| of the card against the CPU over
#: the greedy steps whose contexts agree, set from the readings at seeds
#: 0-11 recorded in PERF.md (``tools/encdec_readings.py``; H100 80GB HBM3,
#: 700 W; not sized at run time): the geometric mean, to two digits, of the
#: largest sound reading (the card, and the plain versions on the card) and
#: the bf16-carrier control's smallest
SEAMLESS_B_LIMIT = 0.1
#: phase 28c: limits of the card against the CPU for one train step, set
#: from the readings at seeds 0-11 recorded in PERF.md by the same rule
#: (``tools/encdec_readings.py``); a distance the control does not exceed
#: at every seed is held to 2.5x its largest sound reading and left out of
#: ``SEAMLESS_CONTROL``, as phase 26e holds ce
SEAMLESS_TRAIN_LIMITS = {"ce": 0.0041, "grads": 0.023, "sign_flips": 0.0023,
                         "updates_sign": 0.019, "updates": 0.1}
SEAMLESS_CONTROL = ("grads", "sign_flips", "updates_sign", "updates")


def seamless_cfg(layers, **kw):
    """seamless-m4t-medium at ``layers`` encoder and ``layers`` decoder
    layers, full width, ``flash_pallas``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SEAMLESS), n_layers=layers,
                               enc_layers=layers,
                               attention_impl="flash_pallas", **kw)


@contextlib.contextmanager
def flash_calls_recorded():
    """Inside, every launch of #7-#10 is tallied by kernel, mask and (Sq,
    Skv): ``{(kernel, "causal" | "full", Sq, Skv): n}``, read from the
    arguments the wrappers hand their launchers."""
    from repro_torch.kernels import flash_attn as fa
    log = {}
    fwd, bwd = fa._launch_fwd, fa._launch_bwd

    def tally(name, causal, q, k):
        key = (name, "causal" if causal else "full", q.shape[1], k.shape[1])
        log[key] = log.get(key, 0) + 1

    def rec_fwd(q, k, v, causal, q_offset, with_lse):
        tally("#8" if with_lse else "#7", causal, q, k)
        return fwd(q, k, v, causal, q_offset, with_lse)

    def rec_bwd(which, q, k, v, do, lse, delta, outs, causal, q_offset,
                library=None):
        tally("#9" if which == "dkdv" else "#10", causal, q, k)
        return bwd(which, q, k, v, do, lse, delta, outs, causal, q_offset,
                   library=library)
    fa._launch_fwd, fa._launch_bwd = rec_fwd, rec_bwd
    try:
        yield log
    finally:
        fa._launch_fwd, fa._launch_bwd = fwd, bwd


def _show_calls(log) -> str:
    return ", ".join(f"{n} {kind} Sq {sq} Skv {skv}: {c}"
                     for (n, kind, sq, skv), c in sorted(log.items()))


def seamless_serve_launches(cfg, frames: int, prompt: int, new: int):
    """The launches of ``greedy_generate`` on the encoder-decoder (the
    reference's loop: one prefill, ``new`` decode steps), by counter and by
    flash call: #3 on ``frame_proj``, an encoder layer's six linears, each
    decoder layer's cross K and V once and the prompt's eight linears a
    layer (self-attention four, the cross-attention's q and output, the
    MLP two), then eight a layer a decode step; #7 once an encoder layer
    (non-causal, frames x frames) and once a decoder layer over the prompt
    (causal against the ``prompt + new``-row self cache); no other
    kernel: the cross-attention reads its precomputed K/V through the plain
    grouped path, a decode step's self-attention through ``_attend``."""
    enc, dec = cfg.enc_layers, cfg.n_layers
    counts = _expect(int8_matmul=1 + 6 * enc + 2 * dec + 8 * dec
                     + 8 * dec * new,
                     flash_attention_fwd=enc + dec)
    calls = {("#7", "full", frames, frames): enc,
             ("#7", "causal", prompt, prompt + new): dec}
    return counts, calls


def seamless_train_calls(cfg, seq: int, frames: int):
    """The flash launches of one encoder-decoder train step under
    ``flash_pallas``: #8 once an attention call and again in its block's
    recomputation, #9 and #10 once -- the encoder's self-attention
    (non-causal, frames x frames), the decoder's (causal, seq x seq) and
    its cross-attention (non-causal, seq x frames), one call a layer
    each."""
    again = 2 if cfg.remat else 1
    out = {}
    for kind, sq, skv, n in (("full", frames, frames, cfg.enc_layers),
                             ("causal", seq, seq, cfg.n_layers),
                             ("full", seq, frames, cfg.n_layers)):
        out[("#8", kind, sq, skv)] = again * n
        out[("#9", kind, sq, skv)] = n
        out[("#10", kind, sq, skv)] = n
    return out


class _Logged:
    """A model whose ``prefill`` and ``decode`` append their logits, on the
    CPU, to ``log`` (what ``greedy_generate`` computed at each step)."""

    def __init__(self, model, log):
        self.model, self.cfg, self.log = model, model.cfg, log

    def prefill(self, *a, **kw):
        out = self.model.prefill(*a, **kw)
        self.log.append(out[0].float().cpu())
        return out

    def decode(self, *a, **kw):
        out = self.model.decode(*a, **kw)
        self.log.append(out[0].float().cpu())
        return out


def _greedy_logged(torch, cfg, params, batch, device, carrier=None,
                   swap=()):
    """``greedy_generate`` of ``SEAMLESS_CHECK_NEW`` tokens on ``device``
    (the carrier ``carrier`` if given; ``swap`` the kernels run in their
    plain versions): {"tokens": (B, new), "logits": (new + 1, B, vocab)},
    the logits of its prefill and of each decode step."""
    from repro_torch.models import build_model
    from repro_torch.train import greedy_generate
    c = dataclasses.replace(cfg, dtype=carrier) if carrier else cfg
    log = []
    with plain_versions(swap):
        toks = greedy_generate(_Logged(build_model(c), log), params, batch,
                               SEAMLESS_CHECK_NEW, policy=FLASH_SERVE_POLICY,
                               device=device)
    return {"tokens": toks, "logits": torch.stack(log)[..., :cfg.vocab_size]}


def seamless_serve_half(torch, cfg, seed):
    """The CPU side of phase 27a: the weights of ``init_params`` (seed + 1)
    at the true fan-in scale, 2 rows of 64 frames (0.1 x normals) and
    64-token prompts, drawn on the CPU, and the CPU's greedy run on them
    (``cpu_half``)."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 1)
    params = true_fan_in(build_model(cfg).init_params(gen, device="cpu"),
                         cfg)
    b = SEAMLESS_CHECK_BATCH
    batch = {"frames": torch.randn((b, SEAMLESS_CHECK_FRAMES, cfg.d_model),
                                   generator=gen) * 0.1,
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (b, SEAMLESS_CHECK_PROMPT),
                                     generator=gen)}
    t1 = time.perf_counter()
    cpu = _greedy_logged(torch, cfg, params, batch, "cpu")
    return dict(params=params, batch=batch, cpu=cpu, draw_s=t1 - t0,
                cpu_s=time.perf_counter() - t1)


def _greedy_distance(torch, got, ref, limit):
    """How far ``got``'s greedy run lies from ``ref``'s: the max |d logit|
    over the steps whose contexts agree (each row's logits up to and with
    its first differing token), the rows that part, and those that part
    where ``ref``'s top-2 margin exceeds ``limit``."""
    tg, tr = got["tokens"], ref["tokens"]
    err, parted, decided = 0.0, 0, 0
    for b in range(tr.shape[0]):
        diff = [i for i in range(tr.shape[1]) if tg[b, i] != tr[b, i]]
        last = diff[0] if diff else tr.shape[1]
        lg, lr = got["logits"][:last + 1, b], ref["logits"][:last + 1, b]
        err = max(err, (lg - lr).abs().max().item())
        if diff:
            parted += 1
            top2 = lr[last].topk(2).values
            decided += int(float(top2[0] - top2[1]) > limit)
    return err, parted, decided


def seamless_serve_card_vs_cpu(torch, dev, seed, strict=True):
    """Phase 27a: ``greedy_generate`` at seamless-m4t-medium's width and
    vocab and 2 + 2 layers (``flash_pallas``: #7 non-causal on the
    encoder, causal on the prompt; #3 on every linear), float32 carrier,
    ``FLASH_SERVE_POLICY``, ``true_fan_in`` weights, on the card against
    the CPU on the same weights and inputs (``seamless_serve_half``): over
    the steps whose contexts agree max |d logit| <= ``SEAMLESS_B_LIMIT``,
    and a row's tokens may part only where the CPU's top-2 margin is
    within the limit; the card with the plain #3 in the kernel's place
    bit-identical (tokens and logits); every kernel in its plain version
    on the card reported against the CPU; the control, the card at the
    bf16 carrier, beyond the limit.  Returns the readings; ``strict=False``
    (``tools/encdec_readings.py``) fails nothing."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = seamless_cfg(SEAMLESS_CHECK_LAYERS, dtype="float32")
    t_start = time.perf_counter()
    half = cpu_half("seamless_serve_half", cfg, seed)
    params, batch, cpu = half["params"], half["batch"], half["cpu"]
    lim = SEAMLESS_B_LIMIT
    card = _greedy_logged(torch, cfg, params, batch, dev)
    err, parted, decided = _greedy_distance(torch, card, cpu, lim)
    mm = _greedy_logged(torch, cfg, params, batch, dev,
                        swap=["int8_matmul"])
    same = (torch.equal(mm["logits"], card["logits"])
            and (mm["tokens"] == card["tokens"]).all())
    plain = _greedy_logged(torch, cfg, params, batch, dev,
                           swap=["int8_matmul"] + list(FLASH_KERNELS))
    plain_err = _greedy_distance(torch, plain, cpu, lim)[0]
    ctl = _greedy_logged(torch, cfg, params, batch, dev, carrier="bfloat16")
    ctl_err = _greedy_distance(torch, ctl, cpu, lim)[0]
    n = SEAMLESS_CHECK_NEW
    agree = int((card["tokens"] == cpu["tokens"]).sum())
    print(f"phase 27a: {cfg.name} {cfg.enc_layers}+{cfg.n_layers}L d="
          f"{cfg.d_model}, float32 carrier, flash_pallas, "
          f"{FLASH_SERVE_POLICY}, greedy_generate of {n} tokens from "
          f"{SEAMLESS_CHECK_BATCH} prompts of {SEAMLESS_CHECK_PROMPT} tokens "
          f"over {SEAMLESS_CHECK_FRAMES} frames: card vs cpu max |dlogit| "
          f"{err:.3e} over the steps whose contexts agree (limit "
          f"{lim:.1e}); tokens equal {agree}/{card['tokens'].size}, "
          f"{parted} rows part ({decided} where the CPU's top-2 margin > "
          f"limit); every kernel plain on the card vs cpu {plain_err:.3e}; "
          f"control, the card at bf16 vs cpu {ctl_err:.3e} (must exceed the "
          f"limit); the plain #3 in the kernel's place "
          f"{'bit-identical' if same else 'DIFFERS'} (tol 0)")
    ok = (err <= lim and decided == 0 and ctl_err > lim and bool(same)
          and bool(torch.isfinite(card["logits"]).all()))
    print_split("phase 27a card vs cpu", half, time.perf_counter() - t_start)
    if strict and not ok:
        fail("phase 27a: the card's greedy run lies outside the limit of "
             "the CPU's, or the control within it, or #3 differs from its "
             "plain version")
    return dict(err=err, plain=plain_err, control=ctl_err, parted=parted,
                decided=decided, mm_plain_same=bool(same))


def serve_seamless(torch, dev, seed):
    """Phase 27b: seamless-m4t-medium served at full width and depth (12 +
    12 layers; random float32 weights from ``seed``, bf16 carrier,
    ``FLASH_SERVE_POLICY``, ``flash_pallas``) by ``greedy_generate``:
    ``SEAMLESS_SERVE_BATCH`` rows of ``enc_len_for(SEAMLESS_SERVE_SEQ)``
    frames, a ``SEAMLESS_PROMPT``-token prompt, ``SEAMLESS_NEW`` new
    tokens; after a warm-up run, the launches exactly
    ``seamless_serve_launches`` by counter and by flash call, prefill ms
    and decode ms a step (each call synchronized), tokens/s, peak memory,
    then one profiled decode step.  Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.models import build_model, enc_len_for
    from repro_torch.models.common import cast_params
    from repro_torch.train import greedy_generate
    gc.collect()
    torch.cuda.empty_cache()
    cfg = seamless_cfg(12)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    b, f = SEAMLESS_SERVE_BATCH, enc_len_for(cfg, SEAMLESS_SERVE_SEQ)
    batch = {"frames": torch.randn((b, f, cfg.d_model), generator=gen,
                                   device=dev) * 0.1,
             "tokens": torch.randint(0, cfg.vocab_size, (b, SEAMLESS_PROMPT),
                                     generator=gen, device=dev)}
    times = {"prefill": [], "decode": []}

    class Timed:
        # each entry point synchronized and timed
        def __init__(self):
            self.cfg = cfg

        def prefill(self, *a, **kw):
            return self._call("prefill", model.prefill, a, kw)

        def decode(self, *a, **kw):
            return self._call("decode", model.decode, a, kw)

        def _call(self, name, fn, a, kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
    greedy_generate(model, params, batch, 2, policy=FLASH_SERVE_POLICY,
                    device=dev)                       # loads the libraries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with flash_calls_recorded() as calls:
        t0 = time.perf_counter()
        toks = greedy_generate(Timed(), params, batch, SEAMLESS_NEW,
                               policy=FLASH_SERVE_POLICY, device=dev)
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want, want_calls = seamless_serve_launches(cfg, f, SEAMLESS_PROMPT,
                                               SEAMLESS_NEW)
    dec = times["decode"]
    print(f"phase 27b serve_seamless: {cfg.name} {cfg.enc_layers}+"
          f"{cfg.n_layers}L d={cfg.d_model}, bf16 carrier, flash_pallas, "
          f"{FLASH_SERVE_POLICY}, greedy_generate: {b} rows of {f} frames, "
          f"{SEAMLESS_PROMPT}-token prompts, {SEAMLESS_NEW} new tokens in "
          f"{wall:.3f} s ({b * SEAMLESS_NEW / wall:.0f} tokens/s); prefill "
          f"{times['prefill'][0]:.1f} ms, decode {sum(dec) / len(dec):.2f} "
          f"ms/step (min {min(dec):.2f}, max {max(dec):.2f}) over "
          f"{len(dec)} steps; peak memory {peak:.2f} GiB; launch counts "
          f"{ {k: v for k, v in counts.items() if v} }; flash calls "
          f"{_show_calls(calls)}")
    if counts != want or calls != want_calls:
        fail(f"phase 27b: launches {counts} / {calls}, expected {want} / "
             f"{want_calls}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("phase 27b: a token outside the vocabulary")
    # one decode step, profiled, from a fresh prefill
    p = cast_params(params, torch.bfloat16)
    with torch.no_grad():
        lg, st = model.prefill(p, batch, policy=FLASH_SERVE_POLICY,
                               max_seq=SEAMLESS_PROMPT + SEAMLESS_NEW)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((b,), SEAMLESS_PROMPT, dtype=torch.int32,
                         device=dev)
        profile_device(torch, lambda: model.decode(
            p, st, tok, pos, policy=FLASH_SERVE_POLICY), "1 decode step")
    return counts


#: phase 28a's kernel check: the cross-attention of a 28a step, (B, Sq,
#: heads, head dim) and Skv -- 4 x 16 heads, 2,048 decoder rows over 512
#: frames, non-causal
SEAMLESS_CROSS_SHAPE, SEAMLESS_CROSS_SKV = (4, 2048, 16, 64), 512


def check_seamless_flash(torch, dev, gen, results):
    """Phase 28a's kernels: #8, #9 and #10 at the cross-attention of a 28a
    step (``SEAMLESS_CROSS_SHAPE``, non-causal, Sq > Skv) against their
    plain versions, a repeat bit-identical, each timed beside its bound,
    its plain version and SDPA (``check_flash_train``)."""
    check_flash_train(torch, dev, gen, results, "seamless_cross",
                      SEAMLESS_CROSS_SHAPE, SEAMLESS_CROSS_SHAPE[2],
                      skv=SEAMLESS_CROSS_SKV, causal=False, cuda_core=False,
                      phase="28a")


def train_seamless(torch, dev, seed):
    """Phase 28a: seamless-m4t-medium pre-training on the card at full
    width and depth (12 + 12 layers), ``SEAMLESS_TRAIN_BATCH`` x
    ``SEAMLESS_TRAIN_SEQ`` decoder tokens over ``enc_len_for`` of it in
    frames a step, ``flash_pallas``, recomputation on (each block one
    checkpoint), ``TRAIN_POLICY`` with int moments, random weights from
    ``seed``: phase 7's checks and numbers (``train``), the launches a step
    exactly ``train_launches`` (385 #3, 193 #4 and #5, one #6, 72 #8, 36
    #9 and #10) and the flash calls exactly ``seamless_train_calls`` --
    #8-#10 non-causal on the encoder's self-attention and on the
    cross-attention at Sq > Skv.  Returns the launch counts."""
    from repro_torch.models import enc_len_for
    gc.collect()
    torch.cuda.empty_cache()
    cfg = seamless_cfg(12)
    with flash_calls_recorded() as calls:
        counts = train(torch, dev, seed, cfg=cfg, batch=SEAMLESS_TRAIN_BATCH,
                       seq=SEAMLESS_TRAIN_SEQ, steps=SEAMLESS_TRAIN_STEPS,
                       tag="phase 28a train_seamless")
    # the main run's steps and the profiled one
    per = seamless_train_calls(cfg, SEAMLESS_TRAIN_SEQ,
                               enc_len_for(cfg, SEAMLESS_TRAIN_SEQ))
    want = {k: v * (SEAMLESS_TRAIN_STEPS + 1) for k, v in per.items()}
    print(f"phase 28a: flash calls over {SEAMLESS_TRAIN_STEPS + 1} steps "
          f"{_show_calls(calls)}")
    if calls != want:
        fail(f"phase 28a: flash calls {calls}, expected {want}")
    return counts


def _seamless_batch(torch, dev, cfg, batch, seq):
    """Step 0 of the loader at ``cfg``: frames and tokens, on ``dev``."""
    from repro_torch.data import Loader, SyntheticCorpus
    got = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                 batch_size=batch, seq_len=seq).peek(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in got.items()}


def seamless_remat(torch, dev, seed):
    """Phase 28b: at ``SEAMLESS_REMAT_LAYERS`` + ``SEAMLESS_REMAT_LAYERS``
    layers and 28a's tokens, one forward and backward with recomputation
    on, one with it off and the first again, from the same weights: ce and
    every gradient bit-identical all three ways, the peak (above the
    weights) lower with recomputation; the launches of each exactly
    ``train_launches``."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = seamless_cfg(SEAMLESS_REMAT_LAYERS)
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = _seamless_batch(torch, dev, cfg, SEAMLESS_TRAIN_BATCH,
                            SEAMLESS_TRAIN_SEQ)
    on = _loss_and_grads(torch, cfg, params, batch)
    off_cfg = dataclasses.replace(cfg, remat=False)
    off = _loss_and_grads(torch, off_cfg, params, batch)
    again = _loss_and_grads(torch, cfg, params, batch)
    d_ce, g_rel, same = _grads_distance(torch, on, off)
    repeat = _grads_distance(torch, on, again)[2]
    show = lambda c: {k: v for k, v in c.items() if v}
    print(f"phase 28b: {cfg.name} {cfg.enc_layers}+{cfg.n_layers}L, "
          f"{SEAMLESS_TRAIN_BATCH} x {SEAMLESS_TRAIN_SEQ} tokens, "
          f"flash_pallas: ce {float(on[0]):.6f} (remat on) vs "
          f"{float(off[0]):.6f} (off); ce and all {len(on[1])} gradients "
          f"{'bit-identical' if same else 'DIFFER'} (tol 0; |d ce| "
          f"{d_ce:.3e}, grads rel L2 {g_rel:.3e}); a second run with remat "
          f"on {'bit-identical' if repeat else 'DIFFERS'}; peak above the "
          f"weights {on[3] / 2 ** 30:.2f} GiB with recomputation, "
          f"{off[3] / 2 ** 30:.2f} GiB without; launches on {show(on[2])}, "
          f"off {show(off[2])}")
    for got, c in ((on[2], cfg), (off[2], off_cfg), (again[2], cfg)):
        want = dict(train_launches(c), fused_adamw_leaves=0)
        if got != want:
            fail(f"phase 28b: launches {show(got)}, expected {show(want)}")
    if not (same and repeat):
        fail("phase 28b: recomputation or a repeat changed ce or a gradient")
    if not on[3] < off[3]:
        fail("phase 28b: the peak is not lower with recomputation")


def seamless_train_card_vs_cpu(torch, dev, seed, strict=True, extra=None):
    """Phase 28c: phase 8's checks for one train step at
    seamless-m4t-medium's width and vocab and 2 + 2 layers (float32
    carrier, recomputation on, ``flash_pallas``,
    ``SEAMLESS_TRAIN_CHECK_BATCH`` x ``SEAMLESS_TRAIN_CHECK_SEQ`` tokens
    over their frames, ``true_fan_in`` weights) within
    ``SEAMLESS_TRAIN_LIMITS``: C's moments compared where the zero points
    agree and dequantized (``zero_points=False``), D, the bf16-carrier
    control, above the limits of ``SEAMLESS_CONTROL``, and E, every
    kernel's plain version on the card, within them
    (``train_card_vs_cpu``)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = seamless_cfg(SEAMLESS_CHECK_LAYERS, dtype="float32")
    return train_card_vs_cpu(torch, dev, seed, cfg=cfg,
                             batch=SEAMLESS_TRAIN_CHECK_BATCH,
                             seq=SEAMLESS_TRAIN_CHECK_SEQ,
                             limits=SEAMLESS_TRAIN_LIMITS, label="phase 28c",
                             control=SEAMLESS_CONTROL, zero_points=False,
                             strict=strict, plain_check=True, extra=extra)


def cpu_jobs(seed: int):
    """The CPU halves the worker computes, in the order the phases take
    them (``cpu_half``'s ``(name, args)``): 16d, 18d, 19d, 20b, 23c, 24d,
    25c, 26e, 27a and 28c.  The checks of GPT-2 (5, 8, 12, 15, 17b) are
    small and compute theirs in place; those of Granite (21d, 22d) replay
    the card's routes, so their CPU side waits for the card."""
    def cell(c):
        return ("card_vs_cpu_half",
                (c.config(n_layers=c.cmp_layers, dtype="float32"), seed))

    def step(cfg, batch, seq):
        return ("train_check_half", (cfg, seed, batch, seq))
    return [cell(YI),
            step(yi_train_cfg(YI_CHECK_LAYERS, dtype="float32"),
                 YI_CHECK_BATCH, YI_CHECK_SEQ),
            cell(GEMMA), cell(QWEN3), cell(MAMBA),
            step(mamba_train_cfg(MAMBA_CHECK_LAYERS, dtype="float32"),
                 MAMBA_CHECK_BATCH, MAMBA_CHECK_SEQ),
            cell(ZAMBA),
            step(zamba_train_cfg(ZAMBA_CHECK_LAYERS, dtype="float32"),
                 ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ),
            ("seamless_serve_half",
             (seamless_cfg(SEAMLESS_CHECK_LAYERS, dtype="float32"), seed)),
            step(seamless_cfg(SEAMLESS_CHECK_LAYERS, dtype="float32"),
                 SEAMLESS_TRAIN_CHECK_BATCH, SEAMLESS_TRAIN_CHECK_SEQ)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'} "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    out_dir = REPO / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "ptxas.log", "w") as f:
        for name in _build.SOURCES:
            log = _build.lib_path(name).with_suffix(".log")
            if log.exists():
                f.write(f"== {name}\n{log.read_text()}\n")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    global _HALVES
    # the CPU halves of the card-vs-CPU checks, off the critical path
    _HALVES = CpuHalves(cpu_jobs(args.seed), torch.get_num_threads())
    print(f"chip_smoke: torch threads {torch.get_num_threads()}; the "
          f"card-vs-CPU checks' CPU sides in a worker process "
          f"({len(_HALVES.jobs)} jobs), at most {CpuHalves.LEAD} ahead",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    results = {}

    def lap(phases):
        # host seconds since the build started, so a later slice sees
        # where the time limit goes
        print(f"chip_smoke: phases {phases} done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def sub(label, fn, *a):
        # one phase's host seconds (where a slice's time limit goes)
        t = time.perf_counter()
        out = fn(*a)
        print(f"chip_smoke: {label} took {time.perf_counter() - t:.1f} s",
              flush=True)
        return out
    ts = (torch, dev, args.seed)
    tg = (torch, dev, gen, results)
    sub("3 check_int8_matmul", check_int8_matmul, *tg)
    sub("3 check_decode_attention", check_decode_attention, *tg)
    sub("3b check_decode_attention_paged", check_decode_attention_paged, *tg)
    sub("3 check_flash_q8", check_flash_q8, *tg)
    serve_counts, dense_tokens, dense_bytes, dense_stats = sub(
        "4 serve", serve, *ts)
    paged_counts = sub("4b serve_paged", serve_paged, *ts, dense_tokens,
                       dense_bytes, dense_stats)
    sub("4c serve_paged_pressure", serve_paged_pressure, *ts)
    sub("5 card_vs_cpu", card_vs_cpu, *ts)
    lap("1-5")
    sub("6 check_int8_bwd", check_int8_bwd, *tg)
    sub("6b check_fused_adamw", check_fused_adamw, *tg)
    train_counts = sub("7 train", train, *ts)
    sub("8 train_card_vs_cpu", train_card_vs_cpu, *ts)
    sub("9 check_qdq", check_qdq, *tg)
    fake_counts = sub("10 train_fake", train_fake, *ts)
    guarded_counts = sub("11 train_guarded", train_guarded, *ts)
    sub("11b train_resume", train_resume, *ts)
    sub("12 train_fake_card_vs_cpu", train_fake_card_vs_cpu, *ts)
    lap("6-12")
    sub("13 check_flash", check_flash, *tg)
    flash_counts = sub("14 train flash_pallas", train, *ts, "flash_pallas")
    serve_flash_counts = sub("14b serve_flash", serve_flash, *ts)
    sub("15 flash_card_vs_cpu", flash_card_vs_cpu, *ts)
    lap("13-15")
    sub("16a cell_kernels", cell_kernels, *tg, YI)
    yi_counts, yi_tokens, yi_stats, yi_params = sub("16b serve_cell",
                                                    serve_cell, *ts, YI)
    yi_paged_counts = sub("16c serve_cell_paged", serve_cell_paged, *ts,
                          yi_params, yi_tokens, yi_stats, YI)
    del yi_params
    sub("16d cell_card_vs_cpu", cell_card_vs_cpu, *ts, YI)
    lap("16")
    dequant_counts = sub("17a serve_dequant", serve_dequant, *ts)
    sub("17b dequant_card_vs_cpu", dequant_card_vs_cpu, *ts)
    ladder_counts = sub("17c serve_ladder", serve_ladder, *ts)
    sub("17d serve_oom", serve_oom, *ts)
    lap("17")
    yi_train_counts = sub("18a train_yi", train_yi, *ts)
    sub("18b yi_remat", yi_remat, *ts)
    yi_xla_counts = sub("18c yi_attend_chunks", yi_attend_chunks, *ts)
    sub("18d yi_train_card_vs_cpu", yi_train_card_vs_cpu, *ts)
    lap("18")
    sub("19a cell_kernels", cell_kernels, *tg, GEMMA)
    gemma_counts, gemma_tokens, gemma_stats, gemma_params = sub(
        "19b serve_cell", serve_cell, *ts, GEMMA)
    gemma_paged_counts = sub("19c serve_cell_paged", serve_cell_paged, *ts,
                             gemma_params, gemma_tokens, gemma_stats, GEMMA)
    del gemma_params
    sub("19d cell_card_vs_cpu", cell_card_vs_cpu, *ts, GEMMA)
    lap("19")
    sub("20a check_int8_cell", check_int8_cell, *tg, QWEN3)
    qwen3_counts, _, _, qwen3_params = sub("20a serve_cell", serve_cell,
                                           *ts, QWEN3)
    del qwen3_params
    sub("20b cell_card_vs_cpu", cell_card_vs_cpu, *ts, QWEN3)
    lap("20")
    sub("21a cell_kernels", cell_kernels, *tg, GRANITE)
    granite_counts, granite_tokens, granite_stats, granite_params = sub(
        "21b serve_cell", serve_cell, *ts, GRANITE)
    granite_paged_counts = sub("21c serve_cell_paged", serve_cell_paged,
                               *ts, granite_params, granite_tokens,
                               granite_stats, GRANITE)
    del granite_params
    sub("21d cell_card_vs_cpu", cell_card_vs_cpu, *ts, GRANITE)
    lap("21")
    sub("22a check_int8_bwd_experts", check_int8_bwd_experts, *tg)
    granite_train_counts = sub("22b train_granite", train_granite, *ts)
    sub("22c granite_remat", granite_remat, *ts)
    sub("22d granite_train_card_vs_cpu", granite_train_card_vs_cpu, *ts)
    lap("22")
    sub("23a check_int8_cell", check_int8_cell, *tg, MAMBA)
    mamba_counts, _, _, mamba_params = sub("23b serve_cell", serve_cell,
                                           *ts, MAMBA)
    del mamba_params
    sub("23c cell_card_vs_cpu", cell_card_vs_cpu, *ts, MAMBA)
    lap("23")
    sub("24a check_int8_bwd_ssm", check_int8_bwd_ssm, *tg)
    mamba_train_counts = sub("24b train_mamba2", train_mamba2, *ts)
    sub("24c mamba_remat", mamba_remat, *ts)
    sub("24d mamba_train_card_vs_cpu", mamba_train_card_vs_cpu, *ts)
    lap("24")
    sub("25a cell_kernels", cell_kernels, *tg, ZAMBA)
    zamba_counts, _, _, zamba_params = sub("25b serve_cell", serve_cell,
                                           *ts, ZAMBA)
    del zamba_params
    sub("25c cell_card_vs_cpu", cell_card_vs_cpu, *ts, ZAMBA)
    lap("25")
    sub("26a check_zamba_train_kernels", check_zamba_train_kernels, *tg)
    zamba_train_counts = sub("26b train_zamba2", train_zamba2, *ts)
    zamba_xla_counts = sub("26c train_zamba2_xla", train_zamba2_xla, *ts)
    sub("26d zamba_remat", zamba_remat, *ts)
    sub("26e zamba_train_card_vs_cpu", zamba_train_card_vs_cpu, *ts)
    lap("26")
    sub("27a seamless_serve_card_vs_cpu", seamless_serve_card_vs_cpu, *ts)
    seamless_counts = sub("27b serve_seamless", serve_seamless, *ts)
    lap("27")
    sub("28a check_seamless_flash", check_seamless_flash, *tg)
    seamless_train_counts = sub("28a train_seamless", train_seamless, *ts)
    sub("28b seamless_remat", seamless_remat, *ts)
    sub("28c seamless_train_card_vs_cpu", seamless_train_card_vs_cpu, *ts)
    lap("28")
    missing = _HALVES.close()
    if missing:
        fail(f"CPU halves queued for the worker and never taken (their "
             f"checks computed their own): "
             f"{[(n, _job_label(a)) for n, a in missing]}")

    # launches: each kernel's count on the main paths, dense serving (phase
    # 4), paged serving (phase 4b), training on the int8 kernels (phase 7),
    # fake-quant training (phase 10), the guarded path (phase 11), flash
    # training (phase 14), flash-prefill serving (phase 14b), Yi-6B
    # served dense and paged (phases 16b and 16c), the dequantize-on-read
    # engines (phase 17a), the ladder's walk (phase 17c) and Yi-6B trained
    # under flash_pallas (phase 18a) and _attend (phase 18c), Gemma-2B
    # served dense and paged (phases 19b and 19c), Qwen3-32B at 16 layers
    # (phase 20a), Granite-3.0-MoE served dense and paged (phases 21b
    # and 21c) and trained (phase 22b), Mamba2-130M served (phase 23b) and
    # trained (phase 24b), Zamba2-2.7B served (phase 25b) and trained under
    # flash_pallas (phase 26b) and _attend (phase 26c), seamless-m4t-medium
    # served (phase 27b) and trained (phase 28a), each path's counts read
    # right after its run
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    kern = []
    for name in KERNEL_NAMES:
        by_path = {"serve": serve_counts[name],
                   "serve_paged": paged_counts[name],
                   "train": train_counts[name],
                   "train_fake": fake_counts[name],
                   "train_guarded": guarded_counts[name],
                   "train_flash": flash_counts[name],
                   "serve_flash": serve_flash_counts[name],
                   "serve_yi": yi_counts[name],
                   "serve_yi_paged": yi_paged_counts[name],
                   "serve_dequant": dequant_counts[name],
                   "serve_ladder": ladder_counts[name],
                   "train_yi": yi_train_counts[name],
                   "train_yi_xla": yi_xla_counts[name],
                   "serve_gemma": gemma_counts[name],
                   "serve_gemma_paged": gemma_paged_counts[name],
                   "serve_qwen3": qwen3_counts[name],
                   "serve_granite": granite_counts[name],
                   "serve_granite_paged": granite_paged_counts[name],
                   "train_granite": granite_train_counts[name],
                   "serve_mamba2": mamba_counts[name],
                   "train_mamba2": mamba_train_counts[name],
                   "serve_zamba2": zamba_counts[name],
                   "train_zamba2": zamba_train_counts[name],
                   "train_zamba2_xla": zamba_xla_counts[name],
                   "serve_seamless": seamless_counts[name],
                   "train_seamless": seamless_train_counts[name]}
        # the kernel gates of the later phases at their models' shapes
        # (Yi's, Gemma's, Granite's, Zamba2's head dim of 160, ...)
        cells = {tag: {k: v[k] for k in keys + ("cuda_core_ms",) if k in v}
                 for tag, v in results[name].items()
                 if isinstance(v, dict) and "ms" in v and "shape" in v}
        kern.append(dict(name=name, launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         **{k: results[name][k] for k in keys},
                         **({"cells": cells} if cells else {})))
    (out_dir / "kernels.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
