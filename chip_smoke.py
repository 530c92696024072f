#!/usr/bin/env python3
"""Drive the PyTorch port's serving and fine-tuning paths once on one
NVIDIA GPU: the natural-layout attention without and with the LayerNorm
kernels, the head-major attention (``attn_natural_layout: false``), the
kernel-drawn hidden-dropout masks (``fuse_hidden_dropout``,
``use_pallas_dropout_mask``), the recomputed feed-forwards (``remat_ff``),
the int-threshold dropout (``use_hash_dropout: false``), the checkpoints
(reference ``.bin`` export and import, native and reference-tar resume),
the two matmul decision probes, the NLVR2, RefCOCO+ and Flickr30k
retrieval heads of ``ctrl_trainval_tasks.yml``, and the plain attention
route with attention-map capture (``--no_pallas``, ``--dump_attn``), the
device store, gradient accumulation, freezing and ``embed_clf``; then the
other families: ViLBERT and LXMERT (dual-stream), VisualBERT and VL-BERT;
then the pretraining path on Conceptual Captions, with K8 (the NCE
negatives' scores); then the retrieval CLI with K9 (the int8 dense layer)
and the optimizers' options; then the serving exporter (``torch.export``
through the registered kernel ops), ``--profile_steps`` and ``use_scan``;
then data parallelism over ``torch.distributed`` (``--distributed``).

    python3 chip_smoke.py [--profile]

(``chip_smoke.py --dp-worker ...`` is one rank of phase 22, which starts
it.)

From the root of a checkout, on a host with a card, nvcc and PyTorch built
for CUDA. Phases, each of which raises (and so exits non-zero) on failure,
and each of which prints its seconds:

1. card: its name and power limit as nvidia-smi gives them; TF32 off;
2. build: the CUDA kernels of ``volta_tpu_torch/ops/csrc`` through first
   use; each band and Hopper-body kernel's registers, stack (spills) and
   shared memory by name, from ``cuobjdump --dump-resource-usage`` of the
   built library; the hash's 32-bit integer instructions an element,
   counted in the SASS of the keep-mask kernel's vector loop
   (``cuobjdump -sass``: those that compute its stores' data, the hash and
   the byte pack, and not its addressing, counter or compare), and the
   card's integer rate (64 INT32 lanes an SM x the SMs x the SM clock
   ``nvidia-smi`` reports), which the bounds of rows 12-14 and K10 use;
   and the registers, stack and spills of rows 1-4 at D = 64 and 128;
3. kernel 1 (attention forward) vs its plain twin on the card, numpy inputs
   with a random padding mask: (a) B=256, L=60, H=12, D=64 bf16 (the
   serving shape), (b) the same in fp32, (c) B=3, Lq=5, Lk=563 bf16 (the
   longest task sequence), and in bf16 the tensor-core body's tile edges
   (Lq and Lk at 63, 64, 65, 128, and Lk=563) with one batch row whose keys
   are all padded but one; tolerances bf16 2e-2 (two bf16 ulps at |x| ~ 2),
   fp32 1e-5; device times at (a) (``kernel_ms``: the card held busy while
   the host enqueues), with ``F.scaled_dot_product_attention`` on the same
   inputs and additive mask as the library yardstick, and the share of the
   bound;
4. kernels 2-4 (attention backward, dropout attention forward and
   backward) vs their twins at the serving shape in bf16 and fp32 and at
   odd shapes (Lq != Lk, Lq < 8, D = 16 and 128), kernels 2 and 4 also in
   bf16 at the tensor-core backward's tile edges (Lq and Lk at 63, 64, 65,
   128) and kernel 3 at the forward's (phase 3's, Lk = 563 among them,
   within 2e-2, its mask bit-equal), with one batch row whose keys are all
   padded but one: dq/dk/dv/db
   and the dropout output within two bf16 ulps of the largest value (fp32
   1e-5 relative), kernels 2's and 4's bf16 dq/dk/dv at (a) and the tile
   edges no more than SPLIT_RATIO times as far from the float64 recipe as
   the twin's (which a single bf16 rounding of P and dS exceeds), the
   dropout mask bit-equal to the twin's, its keep fraction 0.9 +- 0.005 at
   b256; device times (``kernel_ms``) of each kernel and twin at (a) and
   their shares of the bound, kernel 2 beside SDPA's forward + backward;
5. kernels 5-8 (the head-major dropout forward and backward, forward and
   backward) vs their twins at the shapes and tolerances of phase 4: row
   5's [H,B,Lq,Lk] mask bit-equal to the twin's, keep fraction 0.9 +-
   0.005 at b256, row 5 vs rows 3 and 9 on the same operands and seed (the
   same dropped set; its output and mask bit-equal to row 9's, its output
   to row 3's), rows 7, 8 and 6 bit-equal
   to rows 1, 2 and 4 on the same operands there (both dtypes) and at
   phases 3's and 4's tile edges in bf16 (where they are also held to
   their twins, row 6 also to the float64 recipe as in phase 4, and at
   (a)); device times at (a) and shares of the bound, SDPA beside rows 7
   (forward) and 8 (forward + backward);
6. kernels 10-13 (LayerNorm forward and backward, fused dropout + residual
   + LayerNorm forward and backward) vs their twins at the b256 train shape
   (15360 rows of 768) in bf16 and fp32, at 7 and 1000 rows, at the
   classifier width 1536, at the b1024 eval shape (61440 rows) and one row
   past a full wave of row 10's band grid in bf16, one row past a full
   wave of row 13's band grid and at a width where 16-byte access does not
   apply (1000 x 100) in bf16 and fp32:
   y/dx/do within two bf16 ulps of the largest value (fp32 1e-5 relative),
   mean/rstd and dscale/dbias within 1e-5 relative (float32 sums in
   another order), kernel 11's dx, dscale and dbias and kernel 13's do,
   dx, dscale and dbias bit-equal over two calls, the row-12 mask and od bit-equal to the twin's and the mask to
   ``hash_dropout``'s zero pattern, keep fraction 0.9 +- 0.005; device
   times (``kernel_ms``) in bf16 at the train shape, rows 10-11 also at
   the eval shape, each in turns with the torch LayerNorm forward or
   backward as the library yardstick; the host time per call of the
   wrappers and of an eval-mode sublayer tail with and without kernel 10;
7. kernels 9, 14 and K10 (the dropout attention that also draws two
   hidden keep masks, the keep-mask kernel and the hash dropout) vs their
   twins: row 9 at the shapes of phase 4 in bf16 and fp32 and at phase 3's
   tile edges in bf16 (one batch row all padded but one key; within 2e-2
   there), its output and probability mask bit-equal to row 5's for the
   same seed (one body in each dtype), its output bit-equal to row 3's on
   the same operands in bf16 (the tensor-core body, two addressings), its
   hidden masks bit-equal to the twin's hash; row 14 at the train shape
   and odd ones, bit-equal to its twin and to ``hash_dropout``'s zero
   pattern; K10 forward and backward bit-equal to the CPU twin of the same
   inputs at the step's dropout sites (a tail [15360, 768], the embeddings
   [256, 23 | 36, 768], the pooled output [256, 1024]), at an odd size
   with NaN, Inf and -0, and on views 1-7 elements past a 16-byte
   boundary, bf16 and fp32; keep fractions 0.9 +- 0.005 at b256; device
   times (``kernel_ms``) at the train shape, K10 in both dtypes with its
   byte bound;
8. kernels 15 and 16 (the probes' wgrad and matmul + bias + gelu) vs their
   twins at the probes' shapes and ragged ones (row 15 within one float32
   rounding per 16 of the summed length, row 16 within two bf16 ulps),
   each shape with the body that ``ops.matmul.matmul_body`` gives it (the
   Hopper body, required at the probes' shapes, or ``mma.sync``); row 15
   bit-equal over two calls; times of row 15, row 16 with the gelu and
   its bias-only second leg beside their twins, one library call each
   (``torch.mm`` with a float32 output where this torch has it, ``addmm`` +
   gelu, ``addmm``) and the bound; then ``python -m volta_tpu_torch.tools
   .wgrad_probe`` and ``.ffn_probe``'s ``main()`` at their default shapes
   with 3 timed calls, whose launches are counted;
9. eval slice: a synthetic VQA dataroot at full feature width (2048 dims,
   36 boxes, 3129 labels, 1200 train and 1024 val questions, written here
   through the port's own LMDB writer) through
   ``python -m volta_tpu_torch.eval_task``'s ``main()`` with
   ctrl_uniter_base in bf16 and random weights from a seed; kernel 1 must
   run 12 times per batch and no other kernel, all logits must be finite
   and every question must get one answer; one batch is compared with the
   same model on the plain twins in bf16 and, with the same weights, in
   fp32: fp32 logits within 1e-4 (there kernel 1 is the CUDA-core body,
   bit-equal to its twin); in bf16 kernel 1 sums on the tensor cores, in
   another order than its twin, and the logits are held to twice (at
   least 5e-2) the distance between the twins and the twins with the
   attention's sums in float64, with at most 4 more answers flipped than
   that; eval throughput at b256 and b1024, kernels vs twins; with
   ``--profile`` the device time of the b256 and b1024 forwards by kernel;
10. the eval slice again with ``use_pallas_layernorm`` and
   ``use_fused_residual_ln`` on (a copy of the config in a temporary
   directory): kernel 1 12 and kernel 10 29 times per batch, one answer per
   question; one batch through the kernels, the twins and the torch
   LayerNorm path in bf16 and, with the same weights, in fp32: fp32 logits
   within 1e-4 of the twins'; kernels 1 and 10 sum in another order than
   their twins, so bf16 logits differ by a few bf16 ulps after 12 layers,
   and are held as in phase 9, the torch LayerNorm path also counting as
   the twins with other sums; eval
   throughput at b256 and b1024 with the LayerNorm kernels on and off, in
   turns; with ``--profile`` the device time of the b256 and b1024
   forwards by kernel with the LayerNorm kernels on;
11. the eval slice with ``attn_natural_layout: false`` (a copy of the
   config): kernel 7 12 times per batch and no natural kernel, one answer
   per question, logits held to the twins' as in phase 9; one batch
   against the same weights on the natural layout, bf16 and fp32 equal to
   the bit; eval throughput at b256 and b1024, head-major vs natural, in
   turns;
12. train slice: ``python -m volta_tpu_torch.train_task``'s ``main()``, 2
    epochs at b256 in bf16 with the config's dropout: kernels 3 and 4 must
    run exactly 12 times per step, K10 27 times forward and 27 backward
    (24 tails, 2 embeddings, the pooled output; 3 where a LayerNorm or
    mask flag moves the tails, 1 where the config's dropout rates are 0:
    the pooled output's fixed 0.1) and kernel 1 12 times per
    validation batch, losses finite and falling, one VAL line per epoch;
    then at 4 of the 12 layers (``uniter_cut``; a layer's launches where
    these say 12, a tail's where they say 24), 1 epoch of
    the same config with its dropout rates set to 0, which must run kernel
    2 12 times per step; 1 epoch with the LayerNorm flags on, which must
    run kernels 12 and 13 24 times and kernels 10 and 11 5 times per step
    (and kernel 10 5 + 24 times per validation batch); 1 epoch of the
    head-major config, kernels 5 and 6 12 times per step and kernel 7 12
    times per validation batch; 1 epoch of it with dropout 0, kernels 7 and
    8 12 times per step; 1 epoch with ``fuse_hidden_dropout``, kernels 9
    and 6 12 times per step; 1 epoch with ``use_pallas_dropout_mask``,
    kernel 14 24 times and kernels 3 and 4 12 times per step;
13. one fp32 train step at full width (64 rows) with the kernels and with
    the twins from the same weights and seed, with dropout and without,
    without and with the LayerNorm flags, head-major, which is also held to
    the same step on the natural layout, and with each hidden-mask flag and
    both with the LayerNorm flags, which are also held to the same weights
    with the mask flags off (the same seed draws the same masks): the
    losses within 1e-5 relative, every parameter within 2% of the step's
    largest update, the exact launches of each kernel, and whether the
    match is bit-exact; then the gradients of one b256 bf16 batch,
    dropout-free (rows 1-2 or 7-8) and with the config's dropout (rows 3-4
    or 5-6, the twins drawing the same hash masks), natural and
    head-major, and with ``fuse_hidden_dropout`` (rows 9 and 6), with the
    kernels (every backward on the tensor cores)
    against the twins: within twice (at least 5e-2) the twins' distance
    from the twins with the attention's sums in float64;
14. train-step throughput at b256 bf16, inputs on the card (forward,
    backward, clip, AdamW), with the kernels and with the twins, then with
    the LayerNorm kernels on and off, then head-major vs natural, then the
    dropout-free step (rows 1-2, 7-8) head-major vs natural, then each
    hidden-mask flag on vs off, and the peak memory of each; with
    ``--profile`` the device time of a step by kernel, without and with the
    LayerNorm kernels, head-major, dropout-free natural and head-major, and
    with each hidden-mask flag;
15. ``remat_ff``, the int threshold and the checkpoints at b256 bf16, at
    4 of the 12 layers (``uniter_cut``; a layer's launches where these say
    12, a tail's where they say 24):
    (a) the ``remat_ff`` config against the plain one, the same weights and
    seed, by default and with the LayerNorm flags, with torch's default
    algorithms (the token-type table sums its gradient in a fixed order):
    the loss and every gradient of one batch and
    two train steps bit-equal, the exact
    launches a step (the recomputation replays each feed-forward tail: K10,
    or row 12 with the LayerNorm flags, 12 more forward launches); with
    ``use_pallas_dropout_mask`` under ``remat_ff`` row 14 launches none
    (the JAX gate) and the step equals the row-14 step; ms/step and peak
    memory of each in turns, and with ``--profile`` the device time by
    kernel; (b) ``use_hash_dropout: false``: each of the 24 tails' keep
    fraction 0.9 +- 0.005, the same seed twice bit-equal, no K10 at the
    tails, and with ``use_fused_residual_ln`` the tails on row 12; its
    ms/step against the same weights with hash tails; (c) a model exported
    as a reference ``.bin`` read through the eval CLI's loader into other
    weights, its b1024 logits bit-equal; 4 steps uninterrupted, twice,
    against 2 steps, the train
    state saved, fresh objects, restored and 2 more, and the same through
    a reference tar: parameters, moments, losses, counts and generator
    bit-equal (or, where the two uninterrupted runs differ, no further
    apart);
16. task heads: rows 1-4 against their twins at the (B, L) of the task
    paths, bf16 and fp32, as phases 3 and 4 hold them (row 1 at the eval
    forwards' 1024 x 77 and 1024 x 57, rows 1-4 at the train steps' 256 x
    67, 256 x 57 and 128 x 77), with their bf16 device times beside
    SDPA's and the bounds (the twins' and L 64 and 65, the tensor-core
    bodies' 64-row tile edge, untimed since phase 22: PERF.md, PR 15);
    then synthetic
    NLVR2 (1024 statements on 128 image pairs), RefCOCO+ (1026 refs on
    342 images) and Flickr30k retrieval (64 images of the VQA store, 5
    captions each) dataroots at full feature width, written here through
    the port's LMDB writer (the same files as ``tools/make_synth_data.py
    nlvr2|refcoco|retrieval``), with ``ctrl_trainval_tasks.yml``'s TASK12,
    TASK10 and TASK8 fields (each val split its train split); every run
    at 4 of ctrl_uniter_base's 12 layers (``uniter_cut``; the full
    config's plan held to 12 attention and 27 K10 launches a forward, the
    cut's launches from its plan); for NLVR2
    and RefCOCO+ the eval CLI at the yml's eval batch (512 pairs, 1024):
    kernel 1 once a layer a batch and no other kernel, one record an item;
    for each task the train CLI, one epoch at the yml's batch (64, 256,
    64) with the config's dropout and its val loop: kernels 3 and 4 once a
    layer a step, K10 a tail each, 2 embeddings, and the pooled output or,
    for refcoco+'s V-logit head, the region outputs, forward and backward,
    kernel 1 once a layer a val batch, finite losses; one eval batch with the
    kernels and the twins as phase 9 holds VQA's (fp32 within 1e-4; bf16
    within twice, at least 5e-2, the twins' distance from float64
    attention sums), answers flipped reported; eval items/s at that batch
    and train ms/step with its peak memory in bf16, one timed run each;
17. capture, the plain attention route and the rest of the train CLI at
    ctrl_uniter_base's full width: (a) the eval CLI on VQA at b64 with
    ``--dump_attn 2``: the npz keys and shapes, every probability row
    (intra ‖ inter) summing to 1 within 1e-3, the maps within 1e-4 of a
    float64 softmax of the captured queries and keys with the batch's
    padding bias, row 1 12 times a batch and no attention kernel in the
    capture forwards, and the capture route's answers held to the kernel
    route's twins as phase 9 holds the kernels, with no more answers
    flipped against the kernels' than the twins flip against float64
    sums; (b) ``--no_pallas``: the
    eval CLI and a train epoch (4 steps at b256) launch no attention or
    LayerNorm kernel and K10 27 + 27 a step, the plain route's b256 logits
    held to the twins likewise, and its train ms/step and peak memory
    beside the kernel route's in turns (with ``--profile`` its device time
    by kernel family); (c) K = 2 accumulation over two
    b128 halves against the b256 step, fp32 dropout-free: parameters
    within 1e-5, one update on both; (d) a VQA b256 and an NLVR2 b64 step
    from the device store bit-equal to the dense-batch step, the store's
    GiB; (e) ``fixed_layers``: frozen parameters moved by exactly the
    decay term (float32 rounding), undecayed ones not at all; (f)
    ``embed_clf``: ``dense2`` the float64 answer means within 1e-6; (g)
    two default b256 steps' gradients equal to the bit with torch's
    default algorithms; (h) one VQA epoch of the train CLI with
    ``--gradient_accumulation_steps 2 --device_store``, ``fixed_layers``
    and ``embed_clf``: the default route's launches (K10 27 + 27 a
    micro-step), one update every two micro-steps, finite losses, the
    frozen parameters at their decay alone in the saved state;
18. the other families on synthetic VQA at full width, each config under
    the TASK1 fields of its family's yml (``FAMILY_RUNS``), every launch
    count derived from the config's sublayer plan (``plan_counts``: the
    attention launches a forward, one a query stream of a dual-stream
    sublayer; K10's a training forward: the tails, the embeddings' sites
    and the pooled output) and held to the counts of ``FAMILY_COUNTS``:
    the runs at 4 layers a stream (ViLBERT's text stream 5), the full
    width kept (``FAMILY_CUTS``, ``cut_config``: ViLBERT's last text-only
    layer and first two co-attention blocks; LXMERT's first two
    text-and-vision layers and first two cross blocks; VisualBERT's and
    VL-BERT's first four layers), each run's launches derived from the cut
    config's plan: (a) ctrl_vilbert_base through both CLIs, as phase 16
    runs a task: the eval CLI at b1024 (row 1 once a query stream a
    batch, no other kernel), the train CLI one epoch at b256 with the
    config's dropout and its val loop (rows 3 and 4 as often, K10 a tail,
    an embedding site and the pooled output each), one eval
    batch held to the twins, eval items/s, train ms/step and peak memory,
    one timed run each; (b)-(d) vilbert_base (8 heads
    of 128 in its 1024-wide vision stream and co-attention), ctrl_lxmert,
    lxmert (36 regions, ``fusion_method: text``, b32), ctrl_visualbert_base,
    ctrl_vl-bert_base and vl-bert_base (``vl-bert_vqa``, the global feature
    last, [MASK] [CLS] appended): one eval batch of the yml's size held to
    the twins and through the kernels with exact launches, two train steps
    with exact launches and finite losses; after vilbert_base, rows 1-4
    alone at its shapes ((1024 and 256) x (23 x 37, 37 x 23, 37 x 37), D =
    128) against their twins as phase 16 holds the task shapes (their
    times untimed since phase 22: PERF.md, PR 17); (e) ctrl_vilbert_base's
    flags, two b256 steps each with exact launches: the LayerNorm kernels
    (rows 10-13 at every per-stream tail), head-major (rows 5-6, its eval
    logits equal to the natural layout's to the bit), the keep-mask kernel (row
    14), ``remat_ff`` (bit-equal to the plain step, as phase 15 holds it)
    and ``fuse_dual_stream`` (one K10 a joined tail); (f) ctrl_vilbert_base
    exported as a reference ``.bin`` and read back through the eval CLI's
    loader into other weights, its b1024 logits bit-equal;
19. pretraining at examples/ctrl_uniter/concap/train.sh's width
    (``check_pretraining``): (a) a synthetic Conceptual Captions dataroot
    (1024 train and 256 valid images of 10-36 boxes, 2048-d features,
    1601-way class probabilities, the 30522-token vocab; the port's LMDB
    writer and msgpack codec, ``write_synth_cc``), ``train_concap.main``
    with train.sh's flags and ``--in_memory True`` for two epochs (8 b256
    steps, objective 1, KL, and the validation) with exact launches (rows
    3-4 12 a step, K10 27 + 27, row 1 12 a val batch) and its CC lines;
    the same step timed alone (10 steps), its peak (with ``--profile``
    its idle share and device ms by family, and the MLM decoder and its
    log-softmax timed alone); ``train_task --from_pretrained`` of its
    checkpoint for one VQA epoch (the trunk loaded, the ``cls`` heads
    unused, the VQA head at init); (b) the b256 step held to the twins: fp32
    losses and parameters after one update as phase 13 holds the fine-tuning
    step, bf16 gradients within NOISE_FACTOR times the twins' distance from
    float64 attention sums (at least GRAD_TOL), exact launches; (c) K8
    against its twins forward and backward in bf16 and fp32 at b256 and
    b512 x 36 regions (the dense twin) and b256 against the blockwise twin,
    by each body that takes the dtype (``check_k8``: the tensor-core body
    and the gather body in bf16, the gather body in fp32; fp32 within 1e-5
    of the largest; the gather body's bf16 scores on the other bf16
    neighbour than the float64 sums' for at most 1e-4 of them, the
    tensor-core body's at most twice as often as the float32 twin's or
    torch's bf16 all-pairs product's, each within one bf16 ulp of torch's
    product's or of the float64 sums'; two calls equal to the bit), at b256
    the plan equal to its twin
    and the peak memory K8's Function adds, the bf16 times of both bodies
    at b256 and b512 beside the twins', torch's all-pairs matmul + gather,
    JAX's composition backward, ``embedding_bag`` and the bound; a b256
    bf16 NCE step (``visual_target_weights {"2": 1}``) held as (b) with
    K8's plan, forward and backward once each, its ms/step against the
    same step with K8's twins and with JAX's composition, one turn each
    (with ``--profile`` K8's step's device ms by family); (d) one bf16
    step's gradients
    each of lxmert.json (criteria 3-5, ``fusion_method: text``) and
    vl-bert_base.json (criterion 6, no ITM head, the global row last) at 4
    layers a stream (``cut_config``), held as (b) with the launches of their
    plans (``pretrain_counts``); (e) the CLI's model exported as a reference
    ``.bin`` and read back into other weights bit for bit;
20. the retrieval CLI, K9 and the other optimizers: (a) a synthetic
    Flickr30k test split of 1000 images (36 x 2048 regions, two gallery
    chunks of 500, 38 tokens: L 75), ``eval_retrieval.main`` on phase 19's
    exported .bin over 64 captions, 4 a dispatch (2,000 pairs), bf16,
    ``--zero_shot`` and ``--quantize int8``: pairs/s, the metrics, row 1
    12 times a forward and K9a and K9b once per Dense a forward, one bf16
    dispatch held to the twins as phase 9 holds logits, the int8 dispatch
    bit-equal with K9's twins in its place, the int8 route's top-1
    agreement with bf16 printed; (b) K9 against its twins bit for bit at a
    dispatch's three products (M 150,000; K x N 768 x 768, 768 x 3072,
    3072 x 768) and odd shapes (M 7, 1000, 150,001; K 5, 100; N 1, 100;
    and 150,001 x 768 x 100, ragged on the Hopper body), a zero row each,
    dynamic and static scales, bf16 and float32 in and out, the epilogue's
    four float64 ties on each of K9b's bodies, each shape's body
    (``int8_body``) printed, with their times beside the twins', the bound
    (int8 products at 1,979 TOPS), ``torch._int_mm`` + the epilogue and
    the bf16 ``F.linear``; (c) fp32 RAdam on the card against the CPU over
    steps 1-7 within 1e-6 (``radam_on_card``), ``train_task`` at 4 layers with
    ``--optim RAdam --optimizer_state_dtype bfloat16
    --skip_disconnected_params`` and with ``--optimizer_state_dtype
    bfloat16`` (finite losses, exact launches, the saved moments'
    dtypes), the b256 step's ms and peak with float32 AdamW, RAdam and bf16
    moments, one turn each, and lxmert.json at 4 layers a stream: with
    ``skip_disconnected`` its parameters that no gradient reaches stay at
    their initial values for 2 steps, without it the decayed ones move;
    (d) ``train_concap`` at 4 layers from phase 19's .bin (its trunk),
    2 steps with and without ``--trunk_lr_scale 0.1``: each loaded
    parameter's update 0.1x within 1e-6 beyond the rounding of p + u, the
    heads (not loaded) bit-equal;
21. the serving exporter, ``--profile_steps`` and ``use_scan``
    (``check_export``, ``check_profile_steps``, ``check_scan``): (a)
    ``python -m volta_tpu_torch.tools.export_model``'s ``main()`` on
    ctrl_uniter_base VQA at full width, bf16, random weights from seed 0,
    batch symbol b: the loaded kernel artifact (``--use_pallas``) at b256
    and b1024 bit-equal to the live forward with its launches (12 of row
    1) and, at b256, the profiler's port kernels; the same with both
    LayerNorm flags (12 of row 1, 29 of row 10); the int8 artifact
    bit-equal to the live int8 forward, K9a and K9b 78 times each (once
    a Dense of the VQA model); the
    portable artifact with no kernel of the port, its logits held as
    phase 9 holds the twins; the baked artifact's size (then deleted);
    the export and load seconds, the loaded artifact's b1024 pairs/s
    beside the live forward's in turns, one call's host µs through the
    registered op and the eager wrapper; (b) ``train_task
    --profile_steps 3`` at 4 layers, b48, one epoch: the trace in
    ``<logdir>/<run>/`` with the ranges of steps 20-22 alone and, over
    them, rows 3 and 4 and K10 three steps' worth of the plan's launches;
    (c) ``use_scan`` at full width: b256 eval logits held to the loop
    route's as phase 9 holds the twins, and a b256 training step, finite,
    with rows 3 and 4 12 times each and K10 only at the embeddings and
    the pooled output (3 + 3);
22. data parallelism (``check_data_parallel``): (a) ctrl_uniter_base's
    default b256 bf16 step with dropout at 12 layers, 3 steps in a process
    group of one rank over NCCL (a file store) against the plain one-GPU
    step: losses and every parameter equal to the bit, the plan's
    launches, and both steps' ms in turns and device ms by family;
    (b) two ranks sharing the one card over gloo, two processes, at 4
    layers (``uniter_cut``), each on its half of the b256 VQA batch: 3
    steps of the default route in bf16 and in fp32 and of the LayerNorm
    and both mask flags in bf16 (rows 12-13 at the tails, rows 9 and 14
    not launched: their gates close across ranks), and one NCE
    pretraining step of a b64 Conceptual Captions batch whose halves
    differ in masked tokens and regions (K8's plan, forward and backward
    once): each rank's launches the plan's, the ranks' parameters equal
    to the bit after the steps, the losses within DP_LOSS_TOL of the same
    steps in one process on the concatenated batch (fp32 1e-4, bf16
    GRAD_TOL, relative); (c) the default bf16 case over NCCL with one card
    a rank where the host has two or more, else a line saying so; (d)
    ``torchrun --standalone --nproc_per_node 1 -m
    volta_tpu_torch.train_task --distributed`` at 4 layers for one epoch
    over NCCL (started beside (b)): rank 0's checkpoint and VAL line, then
    a one-GPU run of the train CLI that resumes it for its second epoch
    with the plan's launches;
23. the kernels' JSON line (the attention rows also with ``body``, the
    body their wrapper runs in bf16; ``pallas`` false for K10, K8 and K9,
    which replace no Pallas kernel; ``bound_by`` "operations" also where the
    hash's integer operations bound a kernel, which phases 6 and 7 name;
    ``task_heads_launches`` the launches of phase 16's CLI runs,
    ``families_launches`` those of phase 18's runs,
    ``pretrain_cli_launches`` those of phase 19's CLI run; K8's plan,
    forward and backward ``launches`` from phase 19's NCE step, their rows
    also with ``gather_ms``, the gather body's time; K9's from phase 20's
    int8 run, its rows at FFN1's shape with ``shapes``, each product's
    times, K9b's also with ``body``, the body the rule gave it), then
    ``{"ok": true, "device": ...}`` last.

It exits non-zero without a result where CUDA is absent, or where the
package is missing beside it.
"""

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# the floor of the limit on bf16 logits against the twins' (phases 9-11)
LOGIT_TOL = 5e-2
# the float32 model with the LayerNorm kernels vs the twins: float32 sums in
# another order through 12 layers, 8.6e-6 on an H100 (the twins vs the torch
# LayerNorm path 9.3e-6), held with a tenfold margin
LOGIT_TOL_FP32 = 1e-4
# bf16 with kernels that sum in another order than their twins (the
# LayerNorm kernels, the tensor-core attention): the bf16 rounding of 12
# layers lets two summation orders differ by 6e-2 (6.4e-2 LayerNorm kernels
# vs twins, 6.2e-2 twins vs torch on an H100); the kernels are held to
# NOISE_FACTOR times the twins' distance from the same model with other sums
# (the torch LayerNorm path, the attention summing in float64), and to at
# most AGREE_SLACK more flipped answers
NOISE_FACTOR = 2.0
AGREE_SLACK = 4
# the floor of the limit on the bf16 dropout-free gradients against the
# twins' (phase 13), the largest relative L2 distance of a parameter's
# gradient (grad_distance): the bf16 rounding of 12 layers lets two
# summation orders differ by 5.6e-2 at b256 (the twins vs the twins with
# float64 attention sums 5.620e-2, the tensor-core kernels vs the twins
# 5.581e-2, both at bert.embeddings.feat_dense.weight on an H100 80GB HBM3
# at 700 W); the kernels are held to NOISE_FACTOR times the former
GRAD_TOL = 5e-2
# the bf16 backward's mean distance from the float64 recipe, over the twin's
# (split_ratio, phase 4): P and dS enter the kernel's products as bf16 hi +
# lo halves, so its float32 values are the twin's up to the order of the
# sums and both round alike; one bf16 rounding of P and dS, as
# flash-attention kernels do, adds an error of the size of the output's own
# rounding
SPLIT_RATIO = 1.05
STEP_TOL = 0.02
RATE = 0.1
EPS = 1e-12
SERVING = (256, 60, 60, 12, 64)
# phase 16's (B, L, a train shape) of rows 1-4: the eval forwards (row 1)
# of NLVR2 (512 pairs, 40 + 37 tokens) and refcoco+ (1024, 20 + 37); the
# train steps (rows 1-4: row 1 in the val loop, 2 at dropout 0) of
# retrieval (64 x 4 ways, 30 + 37), refcoco+ (256) and NLVR2 (64 pairs)
TASK_SHAPES = ((1024, 77, False), (1024, 57, False), (256, 67, True),
               (256, 57, True), (128, 77, True))
# phase 16's retrieval annotations, tools/make_synth_data.py's file name
RETRIEVAL_ANN = "all_data_final_test_set0_2014.jsonline"
ODD = [(2, 9, 33, 4, 16), (3, 5, 37, 2, 64), (2, 17, 70, 2, 128)]
# the bf16 tensor-core forward's tile edges (64 query rows, 64-key tiles):
# Lq and Lk at 63, 64, 65 and 128, and 563 keys (the longest task sequence)
EDGES = [(4, 63, 65, 12, 64), (4, 64, 64, 12, 128), (4, 65, 128, 12, 16),
         (4, 128, 63, 12, 32), (4, 65, 563, 12, 64)]
# the bf16 tensor-core backward's tile edges (64-row query and key tiles):
# Lq and Lk at 63, 64, 65 and 128
BWD_EDGES = EDGES[:4] + [(4, 128, 128, 12, 64)]
TRAIN_ROWS = (15360, 768)  # the b256 train shape: 256 x 60 rows of 768
EVAL_ROWS = 61440  # the b1024 eval forward's rows (1024 x 60)
# rows 10-11 are timed at both: at 15360 rows each bf16 operand is 24 MB and
# a warm 50 MB L2 can serve part of it, at 61440 (94 MB) it cannot
LN_TIMED = (TRAIN_ROWS, (EVAL_ROWS, 768))
LN_SHAPES = [(TRAIN_ROWS, "bfloat16"), (TRAIN_ROWS, "float32"),
             ((7, 768), "bfloat16"), ((1000, 768), "float32"),
             ((256, 1536), "bfloat16")]
CONFIG = os.path.join(REPO, "configs", "ctrl_uniter_base.json")
CSRC = "volta_tpu_torch/ops/csrc/"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bf16 tensor": 989e12, "fp32": 67e12,  # H100 SXM, dense
            "int8 tensor": 1979e12}
# 32-bit integer lanes of an H100 SM (NVIDIA's Hopper architecture white
# paper: 64 INT32 units an SM; its int32 "TOPS" count a multiply-add as
# two). The integer bound counts the hash's integer instructions that issue
# on these lanes (the ALU pipe: shifts, logic ops, adds, compares,
# selects, byte permutes) at this rate times the SMs times the SM clock
# nvidia-smi reports. IMAD (and IDP) issue on the FMA pipe instead
# (Nsight Compute's pipe names: fmaheavy), beside the ALU: counted at the
# 64 lanes too, row 14 ran faster than that bound (1.007 of it, NVIDIA H100
# 80GB HBM3, 700 W), so they are left out of it.
INT32_LANES_PER_SM = 64
# the per-thread 32-bit integer instructions of the SASS (the uniform
# datapath's U* instructions run once a warp and are not counted), and
# those of them that issue on the FMA pipe
INT_OPCODES = {"IMAD", "IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL",
               "SHR", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "VIMNMX",
               "IABS", "POPC", "FLO", "BMSK", "BREV", "SGXT", "ICMP", "IDP",
               "BFE", "BFI"}
FMA_PIPE_OPCODES = {"IMAD", "IDP"}
# the card's integer rate, per second, and the hash's 32-bit integer
# instructions an element on the ALU pipe; phase 2 fills both
# (hash_int_count)
HASH = {"int_per_s": None, "per_element": None}
# the kernels whose registers and stack phase 2 reports by name: the band
# kernels of rows 10, 11 and 13, their column sums, the Hopper body of rows
# 15 and 16, and row 14, whose SASS phase 2 reads
RESOURCE_KERNELS = ("layer_norm_fwd_kernel", "layer_norm_bwd_kernel",
                    "dropout_residual_ln_bwd_kernel", "band_sum_kernel",
                    "wg::", "keep_mask_kernel", "int8_wgmma_kernel")
# and rows 1-4 at the model paths' head dims, 64 and 128 (vilbert_base's
# wide vision stream and co-attention)
ATTENTION_RESOURCE = (("attention_fwd_kernel", "attention_bwd_kernel",
                       "attention_dropout_fwd_kernel",
                       "attention_dropout_bwd_kernel"), (", 64>", ", 128>"))
# name -> (source, TPU kernel it replaces)
KERNELS = {
    "attention_fwd": ("attention_fwd.cu",
                      "volta_tpu/ops/pallas_attention.py:670"),
    "attention_bwd": ("attention_bwd.cu",
                      "volta_tpu/ops/pallas_attention.py:683"),
    "attention_dropout_fwd": ("attention_dropout.cu",
                              "volta_tpu/ops/pallas_attention.py:510"),
    "attention_dropout_bwd": ("attention_dropout.cu",
                              "volta_tpu/ops/pallas_attention.py:530"),
    "attention_dropout_head_major_fwd": (
        "attention_head_major.cu", "volta_tpu/ops/pallas_attention.py:100"),
    "attention_dropout_head_major_bwd": (
        "attention_head_major.cu", "volta_tpu/ops/pallas_attention.py:169"),
    "attention_head_major_fwd": ("attention_head_major.cu",
                                 "volta_tpu/ops/pallas_attention.py:852"),
    "attention_head_major_bwd": ("attention_head_major.cu",
                                 "volta_tpu/ops/pallas_attention.py:907"),
    "layer_norm_fwd": ("layernorm.cu", "volta_tpu/ops/layernorm.py:27"),
    "layer_norm_bwd": ("layernorm.cu", "volta_tpu/ops/layernorm.py:40"),
    "dropout_residual_ln_fwd": ("fused_residual.cu",
                                "volta_tpu/ops/fused_residual.py:49"),
    "dropout_residual_ln_bwd": ("fused_residual.cu",
                                "volta_tpu/ops/fused_residual.py:72"),
    "attention_dropout_hidden_masks_fwd": (
        "attention_head_major.cu", "volta_tpu/ops/pallas_attention.py:125"),
    "keep_mask": ("dropout_mask.cu", "volta_tpu/ops/dropout_mask.py:28"),
    "hash_dropout_fwd": ("hash_dropout.cu", "volta_tpu/models/layers.py:226"),
    "hash_dropout_bwd": ("hash_dropout.cu", "volta_tpu/models/layers.py:226"),
    "wgrad": ("matmul.cu", "tools/wgrad_probe.py:36"),
    "matmul_bias_act": ("matmul.cu", "tools/pallas_ffn_probe.py:46"),
    "nce_plan": ("nce_scores.cu", "volta_tpu/losses.py:240"),
    "nce_scores_fwd": ("nce_scores.cu", "volta_tpu/losses.py:240"),
    "nce_scores_bwd": ("nce_scores.cu", "volta_tpu/losses.py:240"),
    "int8_quantize": ("int8_dense.cu", "volta_tpu/ops/int8_dense.py:52"),
    "int8_matmul": ("int8_dense.cu", "volta_tpu/ops/int8_dense.py:52"),
}
# K10: the JAX package's hash_dropout, which XLA fuses and no Pallas kernel
# computes; its backward is the same kernel on the cotangent. K8: the NCE
# negatives' scores of nce_2048 (dense, volta_tpu/losses.py:299-317, and
# blockwise, _chunked_neg_scores :144-176), an XLA einsum and gather there;
# its tensor-core body's plan buckets the sampled pairs for it
# K9a and K9b: int8_dense_apply's per-token quantize and its int8 product
# with the dequantizing epilogue, which XLA composes
NOT_PALLAS = ("hash_dropout_fwd", "hash_dropout_bwd", "nce_plan",
              "nce_scores_fwd", "nce_scores_bwd", "int8_quantize",
              "int8_matmul")
# the probes' shapes: the b256 train step's tokens, hidden and FFN widths
PROBE = (15360, 768, 3072)
PROBE_ITERS = 3
# the profile's kernel families, first match wins: the int64 ops are the
# plain hash dropout's mask draws, which K10 replaces wherever it runs; the
# step's other int64 kernels (the embeddings' backward sorts its indices and
# sums by segment, the loss gathers and scatters) are a family of their own
KERNEL_FAMILIES = (
    ("NCCL collectives", ("nccl",)),
    ("attention kernels", ("attention_",)),
    ("LayerNorm kernels (rows 10-11)", ("layer_norm_fwd_kernel",
                                        "layer_norm_bwd_kernel")),
    ("fused residual-LN kernels (rows 12-13)", ("dropout_residual_ln_",)),
    ("band column sums (rows 11, 13)", ("band_sum_kernel",)),
    ("keep-mask kernel (row 14)", ("keep_mask_kernel",)),
    ("hash dropout kernel (K10)", ("hash_dropout_kernel",)),
    ("NCE scores kernel (K8)", ("nce_scores_", "nce_tc::")),
    # every softmax outside the attention kernels: the plain attention
    # route's, the task heads', the MLM's log-softmax over 30522 words and
    # the KL's over 1601 classes
    ("softmax / log-softmax", ("SoftMax", "softmax")),
    ("index sorts, gathers, scatters (int64)", (
        "RadixSort", "DeviceUniqueByKey", "DeviceScan", "krn_partial",
        "partial_segments", "compute_grad_weight", "embedding_backward",
        "gather_kernel", "scatter_gather", "FillFunctor<long>")),
    ("hash dropout (int64 ops)", ("<long", "long>", "arange")),
    ("matmuls", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("torch LayerNorm fwd+bwd", ("layer_norm", "GammaBeta")),
    ("AdamW + clip", ("multi_tensor_apply",)),
    ("gelu fwd+bwd", ("Gelu",)),
    ("casts and copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
)


def ab_turns(name_a, route_a, name_b, route_b):
    """The turns of an A/B on one card: a, b, b, a, a, b, b, a, so that
    drift in the card's or the host's speed falls on both sides alike."""
    a, b = (name_a, route_a), (name_b, route_b)
    return (a, b, b, a) * 2


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name):
    t0 = time.time()
    yield
    print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
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


def kernel_ms(fn, iters=100, warmup=3):
    """Device ms a call of ``fn``, a short kernel's wrapper: ``cuda_ms``
    with the card held busy (``torch.cuda._sleep``) while the host enqueues
    the calls, so that the events time the kernels and not the wrapper's
    host time, which a kernel of a few tens of microseconds can be shorter
    than."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, peak, hashed=0):
    """The least time of a function on the card, ms: the largest of its
    bytes over the memory rate, its operations over the peak rate of their
    type and, for ``hashed`` elements whose keep bit it draws, the hash's
    32-bit integer instructions on the ALU pipe over the card's integer
    rate (``HASH``, phase 2); and which of them it is: "bytes", "operations" or "integer
    operations"."""
    terms = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
             (ops / PEAK_OPS[peak] * 1e3, "operations")]
    if hashed:
        terms.append((hashed * HASH["per_element"] / HASH["int_per_s"] * 1e3,
                      "integer operations"))
    return max(terms, key=lambda t: t[0])


def short_name(mangled):
    """A kernel's name and template arguments, from its mangled symbol
    (``c++filt`` where the host has it)."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return mangled
    name = name.strip().replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].removeprefix("void ")


def cuobjdump():
    """The toolkit's cuobjdump, beside nvcc: phase 2 reads the built
    library with it."""
    from volta_tpu_torch.ops import _build

    tool = _build.toolkit_program("cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"phase 2 needs cuobjdump beside nvcc: no {tool}")
    return tool


def resource_report(lib):
    """Registers, stack frame and static shared memory of every kernel of
    RESOURCE_KERNELS and ATTENTION_RESOURCE, by name, from ``cuobjdump
    --dump-resource-usage`` of
    the built library, with ptxas' spill stores and loads for the same
    symbol from the build log; prints one line each and returns {name:
    (registers, stack, spills, symbol)}."""
    from volta_tpu_torch.ops import _build

    out = subprocess.run([cuobjdump(), "--dump-resource-usage", lib],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    spills = dict(re.findall(
        r"Function properties for (\S+)\n\s+\d+ bytes stack frame, "
        r"(\d+ bytes spill stores, \d+ bytes spill loads)",
        _build.build_log()))
    report = {}
    for sym, regs, stack, shared in re.findall(
            r"Function (\S+):\n\s+REG:(\d+) STACK:(\d+) SHARED:(\d+)", out):
        name = short_name(sym)
        names, dims = ATTENTION_RESOURCE
        if not (any(k in name for k in RESOURCE_KERNELS) or (
                name.split("<")[0] in names
                and any(name.endswith(d) for d in dims))):
            continue
        spill = spills.get(sym, "spills not in the build log")
        report[name] = (int(regs), int(stack), spill, sym)
        print(f"resources {name}: {regs} registers, {stack} bytes stack, "
              f"{shared} bytes static shared memory; {spill}", flush=True)
    return report


def sass_operands(args):
    """The registers and predicates each operand of a SASS instruction
    names, as sets ("R12.64" names R12 and R13)."""
    out = []
    for arg in args.split(","):
        names = set()
        for kind, num, wide in re.findall(
                r"(?<![A-Z])(UR|UP|R|P)(\d+)(\.64)?", arg):
            names.add(f"{kind}{num}")
            if wide:
                names.add(f"{kind}{int(num) + 1}")
        out.append((arg.strip(), names))
    return out


def sass_defs_uses(op, args, guard):
    """What a SASS instruction writes and what it reads: its first operand
    and up to two predicates after it (carry or second compare outputs)
    are written, with a ".WIDE" result a register pair and a ".128" load a
    quad; a store writes nothing; the rest and the guard are read."""
    ops = sass_operands(args)
    wide = lambda names, width: {
        f"{kind}{int(num) + k}" for kind, num in
        (re.fullmatch(r"(\D+)(\d+)", n).groups() for n in names)
        for k in range(width)}
    defs = set()
    if ops and not op.startswith(("ST", "BRA", "EXIT", "BSYNC", "BSSY")):
        defs = wide(ops.pop(0)[1],
                    4 if ".128" in op else 2 if ".WIDE" in op else 1)
        for _ in range(2):
            if ops and re.fullmatch(r"!?(P\d|PT)", ops[0][0]):
                defs |= ops.pop(0)[1]
    if ".WIDE" in op and ops:  # its addend is a pair too
        ops[-1] = (ops[-1][0], wide(ops[-1][1], 2))
    uses = set().union(*(names for _, names in ops))
    if guard:
        uses |= sass_operands(guard.strip().lstrip("@!"))[0][1]
    return defs, uses


def vector_loop(sass, kernel):
    """In the SASS of the kernel whose symbol holds ``kernel``: the loop
    that a backward branch closes and that holds 16-byte global stores
    (the largest, where several do), as a list of (opcode, operands,
    guard)."""
    fn = next(part for part in sass.split("Function : ")[1:]
              if kernel in part.split("\n", 1)[0])
    ins = [(int(a, 16), op, args, guard) for a, guard, op, args in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", fn)]
    best = None
    for addr, op, args, _ in ins:
        target = re.match(r"\s*0x([0-9a-f]+)", args) if op == "BRA" else None
        if target is None or int(target.group(1), 16) > addr:
            continue
        start = int(target.group(1), 16)
        body = [(o, g, u) for a, o, g, u in ins if start <= a <= addr]
        if (any(o.startswith("STG") and ".128" in o for o, _, _ in body)
                and (best is None or len(body) > len(best))):
            best = body
    if best is None:
        raise RuntimeError(f"no vector loop in {kernel}'s SASS")
    return best


def store_data_slice(body):
    """The instructions of a loop body (``vector_loop``) that compute the
    data of its 16-byte stores in one pass: followed back from each
    store's data registers through what writes them, and not through the
    store's address, the loop counter's update and compare or the branch.
    Returns their indices in ``body``."""
    taken = set()
    for k, (op, args, _) in enumerate(body):
        if not (op.startswith("STG") and ".128" in op):
            continue
        data = sass_operands(args)[-1][1]
        need = {f"R{int(r[1:]) + i}" for r in data for i in range(4)}
        for j in range(k - 1, -1, -1):
            defs, uses = sass_defs_uses(*body[j])
            if defs & need:
                taken.add(j)
                if not body[j][2]:
                    need -= defs
                need |= uses
    return sorted(taken)


def int_counts(ops):
    """Of SASS opcodes: the 32-bit integer instructions, and those of them
    on the ALU pipe (all but FMA_PIPE_OPCODES)."""
    ints = [o.split(".")[0] for o in ops if o.split(".")[0] in INT_OPCODES]
    return len(ints), sum(o not in FMA_PIPE_OPCODES for o in ints)


def hash_int_count(lib, symbol):
    """Fill ``HASH``: the card's integer rate (INT32_LANES_PER_SM x the SM
    count x the SM clock nvidia-smi reports) and the hash's 32-bit integer
    instructions an element on the ALU pipe, counted in the SASS of the
    keep-mask kernel (row 14, ``cuobjdump -sass -fun symbol``, its mangled
    name): the integer instructions but IMAD and IDP that compute the data
    of its vector loop's 16-byte stores (the hash and the byte pack;
    ``store_data_slice``), over the 16 elements of each store. The whole
    loop's count, its addressing, counter and compare included, is printed
    beside it."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    HASH["int_per_s"] = INT32_LANES_PER_SM * sms * mhz * 1e6
    sass = subprocess.run([cuobjdump(), "-sass", "-fun", symbol, lib],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    body = vector_loop(sass, "keep_mask_kernel")
    elems = 16 * sum(o.startswith("STG") and ".128" in o for o, _, _ in body)
    loop_ints, loop_alu = int_counts([o for o, _, _ in body])
    hash_ints, hash_alu = int_counts([body[j][0]
                                      for j in store_data_slice(body)])
    HASH["per_element"] = hash_alu / elems
    print(f"hash: the keep-mask kernel's vector loop, {len(body)} "
          f"instructions for {elems} elements: {loop_ints} integer "
          f"instructions, {loop_alu} on the ALU pipe "
          f"({loop_alu / elems:.4f} an element); of them the hash and the "
          f"byte pack {hash_ints}, {hash_alu} on the ALU pipe "
          f"({HASH['per_element']:.4f} an element, the bound's count); "
          f"the card's integer rate {INT32_LANES_PER_SM} lanes x {sms} SMs "
          f"x {mhz:.0f} MHz = {HASH['int_per_s'] / 1e12:.4f} T "
          f"instructions/s", flush=True)


def attention_bound(b, lq, lk, h, d, itemsize, backward, mask=False,
                    hidden=False):
    """Forward: q, k, v, bias read, out written; 4·B·H·Lq·Lk·D operations
    (QKᵀ and PV). Backward: q, k, v, g, bias read, dq, dk, dv written;
    10·B·H·Lq·Lk·D (QKᵀ again, dV, dP, dQ, dK). With ``mask`` the
    [H,B,Lq,Lk] uint8 keep mask written (forward) or read (backward); with
    ``hidden`` row 9's two [B,Lq,H·D] uint8 hidden masks written."""
    rows = b * (3 * lq + 4 * lk) if backward else b * (2 * lq + 2 * lk)
    nbytes = (rows * h * d * itemsize + b * lk * 4 + mask * b * h * lq * lk
              + hidden * 2 * b * lq * h * d)
    return bound(nbytes, (10 if backward else 4) * b * h * lq * lk * d,
                 "bf16 tensor")


def row_bound(name, n, d, itemsize):
    """Rows 10-13 over [n, d]: each [n, d] operand read or written once, the
    [d] float32 vectors and [n] float32 statistics once; float32 operations
    per element (statistics, normalisation, VJP) on the CUDA cores; rows 12
    and 13 also the hash of every element's keep bit (chip_smoke times them
    with dropout)."""
    rows, vecs, stats, ops = {
        "layer_norm_fwd": (2, 2, 2, 8),            # x -> y; w, b; mean, rstd
        "layer_norm_bwd": (3, 3, 2, 13),           # g, x -> dx; w, dw, db
        "dropout_residual_ln_fwd": (4, 2, 2, 10),  # o, x -> y, od
        "dropout_residual_ln_bwd": (5, 3, 2, 15),  # g, od, x -> do, dx
    }[name]
    nbytes = rows * n * d * itemsize + vecs * d * 4 + stats * n * 4
    return bound(nbytes, ops * n * d, "fp32",
                 hashed=n * d if name.startswith("dropout_") else 0)


# K10's launches a training forward, and as many backward: the 24 sublayer
# tails, the two embedding outputs and the pooled output (for a V-logit
# head the region outputs instead: it reads no pooled output, whose seed is
# drawn and whose dropout is not run); the 3 that are no
# tail where a flag moves the tails to rows 12, 14 or 9; the pooled output's
# alone where the config's dropout rates are 0 (its rate is the head's fixed
# 0.1, models/model.py, as in the JAX module)
K10_SITES, K10_FLAGGED, K10_POOLED = 27, 3, 1


def k10(n):
    """K10's counts for n dropouts, forward and backward."""
    return {"hash_dropout_fwd": n, "hash_dropout_bwd": n}


def expect(**counts):
    """A full launch table: the given counts, every other kernel 0."""
    from volta_tpu_torch.ops import LAUNCHES

    return {name: counts.get(name, 0) for name in LAUNCHES}


def attention_inputs(b, lq, lk, h, d, dtype, seed):
    import torch

    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    mk = lambda l: torch.from_numpy(
        rng.randn(b, l, h * d).astype(np.float32)).to(dev, dtype)
    q, k, v = mk(lq), mk(lk), mk(lk)
    mask = (rng.rand(b, lk) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    bias = torch.from_numpy((1.0 - mask) * -10000.0).to(dev)
    return q, k, v, bias


def sdpa_operands(q, k, v, bias, h):
    """q, k, v [B, L, H·D] as SDPA's [B, H, L, D] and the additive bias as
    a [B, 1, 1, Lk] mask in their dtype: the library yardstick's inputs."""
    b, lk = bias.shape
    heads = lambda x: x.view(x.shape[0], x.shape[1], h, -1).transpose(1, 2)
    return (heads(q), heads(k), heads(v),
            bias.view(b, 1, 1, lk).to(q.dtype))


def check_kernel(attention_cuda):
    """Phase 3: kernel 1 against its twin at three shapes and, in bf16, at
    the tensor-core body's tile edges, one batch row with every key but one
    padded; the times of the kernel, its twin and SDPA on the same inputs
    at the serving shape, beside the bound."""
    import torch
    import torch.nn.functional as F

    shapes = [("a", SERVING, "bfloat16", ord("a")),
              ("b", SERVING, "float32", ord("b")),
              ("c", (3, 5, 563, 12, 64), "bfloat16", ord("c"))]
    shapes += [(f"edge {i}", s, "bfloat16", 300 + i)
               for i, s in enumerate(EDGES)]
    report = {}
    for tag, (b, lq, lk, h, d), dt, seed in shapes:
        q, k, v, bias = attention_inputs(b, lq, lk, h, d, getattr(torch, dt),
                                         seed=seed)
        if tag.startswith("edge"):
            bias[0, 1:] = -10000.0
        out = attention_cuda.attention_fwd(q, k, v, bias, d ** -0.5, h)
        torch.cuda.synchronize()
        ref = attention_cuda.attention_fwd_ref(q, k, v, bias, d ** -0.5, h)
        err = float((out.float() - ref.float()).abs().max())
        ok = out.shape == ref.shape and out.dtype == ref.dtype \
            and bool(torch.isfinite(out).all()) and err <= TOL[dt]
        print(f"kernel ({tag}) B={b} Lq={lq} Lk={lk} H={h} D={d} {dt}: "
              f"max abs diff vs twin {err:.3e} (tol {TOL[dt]:g})", flush=True)
        if not ok:
            raise RuntimeError(f"attention kernel disagrees at shape {tag}")
        if tag == "a":
            report["max_abs_err"] = err
            ms = kernel_ms(lambda: attention_cuda.attention_fwd(
                q, k, v, bias, d ** -0.5, h), iters=100)
            plain_ms = kernel_ms(lambda: attention_cuda.attention_fwd_ref(
                q, k, v, bias, d ** -0.5, h), iters=100)
            ms2 = kernel_ms(lambda: attention_cuda.attention_fwd(
                q, k, v, bias, d ** -0.5, h), iters=100)
            sq, sk, sv, mask = sdpa_operands(q, k, v, bias, h)
            lib_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask), iters=100)
            report.update(ms=(ms + ms2) / 2, plain_ms=plain_ms,
                          library_ms=lib_ms,
                          bound=attention_bound(b, lq, lk, h, d, 2, False))
            print(f"kernel (a) time {report['ms']:.4f} ms (runs {ms:.4f}, "
                  f"{ms2:.4f}), plain twin {plain_ms:.4f} ms, SDPA "
                  f"{lib_ms:.4f} ms, bound {report['bound'][0]:.4f} ms "
                  f"({report['bound'][1]}), "
                  f"{report['bound'][0] / report['ms']:.3f} of the bound",
                  flush=True)
    return report


def close(got, ref, dtype, what):
    """Max abs difference of got vs ref; raises past two bf16 ulps of the
    largest |ref| (bf16) or 1e-5 * max(1, |ref|) (fp32)."""
    import torch

    top = float(ref.float().abs().max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float((got.float() - ref.float()).abs().max())
    if got.shape != ref.shape or got.dtype != ref.dtype \
            or not bool(torch.isfinite(got).all()) or err > tol:
        raise RuntimeError(f"{what}: max abs diff {err:.3e} over tol "
                           f"{tol:.3e}")
    return err


def split_ratio(got, q, k, v, bias, g, scale, h, shape, keep=None,
                row="kernel 2"):
    """The largest over dq, dk, dv of mean|got - R64| / mean|twin - R64|:
    R64 the backward recipe in float64 on the same bf16 operands, twin the
    plain twin (float32, then rounded to bf16), got the kernel's ([B, L,
    H·D]); with ``keep`` (the [B,H,Lq,Lk] mask of rows 4 and 6) the dropout
    recipe and twin. Near 1 where the kernel's float32 values are the
    recipe's, as with P (P·keep) and dS in hi + lo halves; raises past
    SPLIT_RATIO, which one bf16 rounding of P and dS exceeds."""
    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

    heads = lambda x: x.view(x.shape[0], x.shape[1], h, -1)  # noqa: E731
    exact = ac.attention_bwd_math(*(heads(x.double()) for x in (q, k, v)),
                                  bias.double(), heads(g.double()), scale,
                                  keep, adc.keep_scale(RATE))
    if keep is None:
        twin = ac.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                    want_db=False)
    else:
        twin = adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, h,
                                             RATE, keep)
    ratio = max(float((a.double() - r.reshape(a.shape)).abs().mean()
                      / (t.double() - r.reshape(a.shape)).abs().mean())
                for a, t, r in zip(got[:3], twin[:3], exact[:3]))
    print(f"{row} at {shape} bfloat16: mean distance from the float64 "
          f"recipe {ratio:.4f} x the twin's (limit {SPLIT_RATIO})",
          flush=True)
    if ratio > SPLIT_RATIO:
        raise RuntimeError(f"{row} at {shape} is {ratio:.4f} x as far "
                           "from the float64 recipe as the twin: P or dS "
                           "rounded before its product")
    return ratio


def check_train_kernels():
    """Phase 4: kernels 2-4 against their twins, kernels 2 and 4 also at
    the bf16 tensor-core backward's tile edges and kernel 3 at the
    forward's, with one batch row whose keys are all padded but one, and
    kernels 2 and 4 in bf16 against the float64 recipe there and at (a)
    (``split_ratio``); their times at (a) (``kernel_ms``) and shares of the
    bound, and SDPA's forward + backward beside kernel 2."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

    report = {}
    for i, shape in enumerate([SERVING] + ODD):
        b, lq, lk, h, d = shape
        for dt in ("bfloat16", "float32"):
            q, k, v, bias = attention_inputs(b, lq, lk, h, d,
                                             getattr(torch, dt), 100 + i)
            g = torch.randn_like(q)
            scale, seed = d ** -0.5, 1000 + i
            got = ac.attention_bwd(q, k, v, bias, g, scale, h, want_db=True)
            out, mask = adc.attention_dropout_fwd(q, k, v, bias, scale, h,
                                                  RATE, seed,
                                                  return_mask=True)
            dgot = adc.attention_dropout_bwd(q, k, v, bias, g, scale, h,
                                             RATE, seed)
            torch.cuda.synchronize()
            ref = ac.attention_bwd_ref(q, k, v, bias, g, scale, h)
            keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device="cuda")
            if not torch.equal(mask, keep):
                raise RuntimeError(f"dropout mask differs from the twin's "
                                   f"at {shape} {dt}")
            oref = adc.attention_dropout_fwd_ref(q, k, v, bias, scale, h,
                                                 RATE, keep)
            dref = adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, h,
                                                 RATE, keep)
            errs = {
                "attention_bwd": max(close(a, r, dt, f"kernel 2 {n}")
                                     for n, a, r in zip("q k v b".split(),
                                                        got, ref)),
                "attention_dropout_fwd": close(out, oref, dt, "kernel 3"),
                "attention_dropout_bwd": max(close(a, r, dt, "kernel 4")
                                             for a, r in zip(dgot, dref))}
            frac = float(mask.float().mean())
            print(f"kernels 2-4 B={b} Lq={lq} Lk={lk} H={h} D={d} {dt}: "
                  f"max abs diff vs twins {errs['attention_bwd']:.3e} / "
                  f"{errs['attention_dropout_fwd']:.3e} / "
                  f"{errs['attention_dropout_bwd']:.3e}, mask bit-equal, "
                  f"keep fraction {frac:.5f}", flush=True)
            if shape == SERVING:
                if abs(frac - (1 - RATE)) > 0.005:
                    raise RuntimeError(f"keep fraction {frac} at b256")
                if dt == "bfloat16":
                    report = {n: {"max_abs_err": e} for n, e in errs.items()}
                    args = (q, k, v, bias, g, scale, h, seed)
                    split_ratio(got, q, k, v, bias, g, scale, h, shape)
                    split_ratio(dgot, q, k, v, bias, g, scale, h, shape,
                                keep=keep, row="kernel 4")
    for i, (b, lq, lk, h, d) in enumerate(BWD_EDGES):
        q, k, v, bias = attention_inputs(b, lq, lk, h, d, torch.bfloat16,
                                         500 + i)
        bias[0, 1:] = -10000.0
        g = torch.randn_like(q)
        seed = 1500 + i
        got = ac.attention_bwd(q, k, v, bias, g, d ** -0.5, h, want_db=True)
        dgot = adc.attention_dropout_bwd(q, k, v, bias, g, d ** -0.5, h,
                                         RATE, seed)
        torch.cuda.synchronize()
        ref = ac.attention_bwd_ref(q, k, v, bias, g, d ** -0.5, h)
        keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device="cuda")
        dref = adc.attention_dropout_bwd_ref(q, k, v, bias, g, d ** -0.5, h,
                                             RATE, keep)
        err = max(close(a, r, "bfloat16", f"kernel 2 {n} at {BWD_EDGES[i]}")
                  for n, a, r in zip("q k v b".split(), got, ref))
        derr = max(close(a, r, "bfloat16", f"kernel 4 d{n} at "
                         f"{BWD_EDGES[i]}")
                   for n, a, r in zip("qkv", dgot, dref))
        print(f"kernels 2 / 4 B={b} Lq={lq} Lk={lk} H={h} D={d} bfloat16: "
              f"max abs diff vs twins {err:.3e} / {derr:.3e}", flush=True)
        split_ratio(got, q, k, v, bias, g, d ** -0.5, h, BWD_EDGES[i])
        split_ratio(dgot, q, k, v, bias, g, d ** -0.5, h, BWD_EDGES[i],
                    keep=keep, row="kernel 4")
    for i, (b, lq, lk, h, d) in enumerate(EDGES):
        q, k, v, bias = attention_inputs(b, lq, lk, h, d, torch.bfloat16,
                                         700 + i)
        bias[0, 1:] = -10000.0
        seed = 1700 + i
        out, mask = adc.attention_dropout_fwd(q, k, v, bias, d ** -0.5, h,
                                              RATE, seed, return_mask=True)
        torch.cuda.synchronize()
        keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device="cuda")
        if not torch.equal(mask, keep):
            raise RuntimeError(f"row-3 mask differs from the twin's at "
                               f"{EDGES[i]}")
        ref = adc.attention_dropout_fwd_ref(q, k, v, bias, d ** -0.5, h, RATE,
                                            keep)
        err = float((out.float() - ref.float()).abs().max())
        print(f"kernel 3 B={b} Lq={lq} Lk={lk} H={h} D={d} bfloat16: max "
              f"abs diff vs twin {err:.3e} (tol {TOL['bfloat16']:g}), mask "
              "bit-equal", flush=True)
        if out.shape != ref.shape or out.dtype != ref.dtype \
                or not bool(torch.isfinite(out).all()) \
                or err > TOL["bfloat16"]:
            raise RuntimeError(f"kernel 3 disagrees at {EDGES[i]}")
    q, k, v, bias, g, scale, h, seed = args
    b, lq, lk, d = q.shape[0], q.shape[1], k.shape[1], q.shape[2] // h
    shape = (b, h, lq, lk)
    pairs = {
        "attention_bwd": (
            lambda: ac.attention_bwd(q, k, v, bias, g, scale, h),
            lambda: ac.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                         want_db=False)),
        "attention_dropout_fwd": (
            lambda: adc.attention_dropout_fwd(q, k, v, bias, scale, h, RATE,
                                              seed),
            lambda: adc.attention_dropout_fwd_ref(
                q, k, v, bias, scale, h, RATE,
                adc.keep_mask(seed, shape, RATE, device="cuda"))),
        "attention_dropout_bwd": (
            lambda: adc.attention_dropout_bwd(q, k, v, bias, g, scale, h,
                                              RATE, seed),
            lambda: adc.attention_dropout_bwd_ref(
                q, k, v, bias, g, scale, h, RATE,
                adc.keep_mask(seed, shape, RATE, device="cuda")))}
    for name, (kern, plain) in pairs.items():
        ms = kernel_ms(kern, iters=50)
        plain_ms = kernel_ms(plain, iters=50)
        ms2 = kernel_ms(kern, iters=50)
        report[name].update(
            ms=(ms + ms2) / 2, plain_ms=plain_ms, library_ms=None,
            bound=attention_bound(b, lq, lk, h, d, 2,
                                  name != "attention_dropout_fwd"))
        bound_ms = report[name]["bound"][0]
        print(f"{name} (a) time {(ms + ms2) / 2:.4f} ms (runs {ms:.4f}, "
              f"{ms2:.4f}), plain twin {plain_ms:.4f} ms (mask draw "
              f"included), bound {bound_ms:.4f} ms, "
              f"{2 * bound_ms / (ms + ms2):.3f} of the bound", flush=True)
    # the library yardstick of kernel 2: SDPA forward + backward
    sq, sk, sv, mask = sdpa_operands(q, k, v, bias, h)
    leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]
    sg = g.view(b, lq, h, d).transpose(1, 2)
    lib_ms = kernel_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, attn_mask=mask), leaves, sg),
        iters=50)
    row2 = report["attention_bwd"]
    row2["library_ms"] = lib_ms
    print(f"attention_bwd library yardstick: SDPA forward + backward "
          f"{lib_ms:.4f} ms; kernel 2 at {row2['bound'][0] / row2['ms']:.3f} "
          "of its bound", flush=True)
    return report


def head_major(x, h):
    """[B, L, H·D] -> contiguous [H, B, L, D]."""
    b, l, hd = x.shape
    return x.view(b, l, h, hd // h).permute(2, 0, 1, 3).contiguous()


def natural(x):
    """[H, B, L, D] -> [B, L, H·D]."""
    h, b, l, d = x.shape
    return x.permute(1, 2, 0, 3).reshape(b, l, h * d)


def check_head_major_kernels():
    """Phase 5: kernels 5-8 against their twins at the shapes of phase 4;
    rows 5-6 against rows 3-4 for one seed on the same operands; rows 7, 5,
    8 and 6 equal to rows 1, 3, 2 and 4 bit for bit there, and row 5's
    output and mask to row 9's (one body each; row 8's summed bias
    gradient within float32 rounding) and, in bf16, at the tile edges of
    phases 3 and 4, where they are also held to their twins, row 6 also to
    the float64 recipe (``split_ratio``) there and at (a); their times at
    (a) and shares of the bound, SDPA beside rows 7 and 8."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc

    def same_as_row_1(out, q3, k3, v3, bias, scale, h, what):
        if not torch.equal(natural(out),
                           ac.attention_fwd(q3, k3, v3, bias, scale, h)):
            raise RuntimeError(f"row 7 differs from row 1 at {what}")

    def same_as_row_2(got, q3, k3, v3, bias, g3, scale, h, what):
        nat = ac.attention_bwd(q3, k3, v3, bias, g3, scale, h, want_db=True)
        if not all(torch.equal(natural(a), r)
                   for a, r in zip(got[:3], nat[:3])):
            raise RuntimeError(f"row 8 differs from row 2 at {what}")
        db = float((got[3].sum(0) - nat[3]).abs().max())
        if db > 1e-5 * max(1.0, float(nat[3].abs().max())):
            raise RuntimeError(f"row 8's bias gradient differs from row 2's "
                               f"by {db:.3e} at {what}")

    def same_as_row_4(got, nat, what):
        if not all(torch.equal(natural(a), r) for a, r in zip(got, nat)):
            raise RuntimeError(f"row 6 differs from row 4 at {what}")

    report = {}
    for i, shape in enumerate([SERVING] + ODD):
        b, lq, lk, h, d = shape
        for dt in ("bfloat16", "float32"):
            q3, k3, v3, bias = attention_inputs(b, lq, lk, h, d,
                                                getattr(torch, dt), 200 + i)
            g3 = torch.randn_like(q3)
            q, k, v, g = (head_major(x, h) for x in (q3, k3, v3, g3))
            scale, seed = d ** -0.5, 2000 + i
            out = ahm.attention_head_major_fwd(q, k, v, bias, scale)
            got = ahm.attention_head_major_bwd(q, k, v, bias, g, scale,
                                               want_db=True)
            dout, mask = ahm.attention_dropout_head_major_fwd(
                q, k, v, bias, scale, RATE, seed)
            dgot = ahm.attention_dropout_head_major_bwd(q, k, v, bias, g,
                                                        mask, scale, RATE)
            nout, nmask = adc.attention_dropout_fwd(
                q3, k3, v3, bias, scale, h, RATE, seed, return_mask=True)
            ngot = adc.attention_dropout_bwd(q3, k3, v3, bias, g3, scale, h,
                                             RATE, seed)
            out9, mask9 = ahc.attention_dropout_hidden_masks_fwd(
                q, k, v, bias, scale, RATE, seed, RATE, seed + 1,
                seed + 2)[:2]
            torch.cuda.synchronize()
            same_as_row_1(out, q3, k3, v3, bias, scale, h, f"{shape} {dt}")
            same_as_row_2(got, q3, k3, v3, bias, g3, scale, h,
                          f"{shape} {dt}")
            keep = ahm.keep_mask_head_major(seed, (h, b, lq, lk), RATE,
                                            device="cuda")
            if not torch.equal(mask, keep):
                raise RuntimeError(f"row-5 mask differs from the twin's at "
                                   f"{shape} {dt}")
            if not torch.equal(mask.transpose(0, 1).bool(), nmask):
                raise RuntimeError(f"rows 5 and 3 drop other probabilities "
                                   f"at {shape} {dt}")
            ref = ahm.attention_head_major_bwd_ref(q, k, v, bias, g, scale)
            dref = ahm.attention_dropout_head_major_bwd_ref(
                q, k, v, bias, g, keep, scale, RATE)
            errs = {
                "attention_head_major_fwd": close(
                    out, ahm.attention_head_major_fwd_ref(q, k, v, bias,
                                                          scale),
                    dt, "kernel 7"),
                "attention_head_major_bwd": max(
                    close(a, r, dt, f"kernel 8 {n}") for n, a, r in
                    zip(("dq", "dk", "dv", "db_part"), got, ref)),
                "attention_dropout_head_major_fwd": close(
                    dout, ahm.attention_dropout_head_major_fwd_ref(
                        q, k, v, bias, scale, RATE, keep), dt, "kernel 5"),
                "attention_dropout_head_major_bwd": max(
                    close(a, r, dt, "kernel 6") for a, r in zip(dgot, dref))}
            if not (torch.equal(natural(dout), nout)
                    and torch.equal(dout, out9)
                    and torch.equal(mask, mask9)):
                raise RuntimeError(f"row 5 differs from row 3's output or "
                                   f"row 9's output or mask at {shape} {dt}")
            same_as_row_4(dgot, ngot, f"{shape} {dt}")
            frac = float(mask.float().mean())
            print(f"kernels 7/8/5/6 B={b} Lq={lq} Lk={lk} H={h} D={d} {dt}: "
                  "max abs diff vs twins "
                  + " / ".join(f"{e:.3e}" for e in errs.values())
                  + f", mask bit-equal to the twin's and to kernels 3's and "
                  f"9's, kernels 7, 5, 8 and 6 bit-equal to kernels 1, 3, 2 "
                  f"and 4, kernel 5 to kernel 9, keep fraction "
                  f"{frac:.5f}", flush=True)
            if shape == SERVING:
                if abs(frac - (1 - RATE)) > 0.005:
                    raise RuntimeError(f"row-5 keep fraction {frac} at b256")
                if dt == "bfloat16":
                    report = {n: {"max_abs_err": e} for n, e in errs.items()}
                    args = (q, k, v, bias, g, mask, scale, h, seed)
                    split_ratio([natural(a) for a in dgot], q3, k3, v3, bias,
                                g3, scale, h, shape, keep=nmask,
                                row="kernel 6")
    for i, (b, lq, lk, h, d) in enumerate(EDGES):
        q3, k3, v3, bias = attention_inputs(b, lq, lk, h, d, torch.bfloat16,
                                            400 + i)
        bias[0, 1:] = -10000.0
        q, k, v = (head_major(x, h) for x in (q3, k3, v3))
        out = ahm.attention_head_major_fwd(q, k, v, bias, d ** -0.5)
        torch.cuda.synchronize()
        err = close(out, ahm.attention_head_major_fwd_ref(q, k, v, bias,
                                                          d ** -0.5),
                    "bfloat16", f"kernel 7 at {EDGES[i]}")
        same_as_row_1(out, q3, k3, v3, bias, d ** -0.5, h, EDGES[i])
        print(f"kernel 7 B={b} Lq={lq} Lk={lk} H={h} D={d} bfloat16: max "
              f"abs diff vs twin {err:.3e}, bit-equal to kernel 1",
              flush=True)
    for i, (b, lq, lk, h, d) in enumerate(BWD_EDGES):
        q3, k3, v3, bias = attention_inputs(b, lq, lk, h, d, torch.bfloat16,
                                            600 + i)
        bias[0, 1:] = -10000.0
        g3 = torch.randn_like(q3)
        q, k, v, g = (head_major(x, h) for x in (q3, k3, v3, g3))
        seed, scale = 2500 + i, d ** -0.5
        mask = ahm.keep_mask_head_major(seed, (h, b, lq, lk), RATE,
                                        device="cuda")
        got = ahm.attention_head_major_bwd(q, k, v, bias, g, scale,
                                           want_db=True)
        dgot = ahm.attention_dropout_head_major_bwd(q, k, v, bias, g, mask,
                                                    scale, RATE)
        torch.cuda.synchronize()
        ref = ahm.attention_head_major_bwd_ref(q, k, v, bias, g, scale)
        dref = ahm.attention_dropout_head_major_bwd_ref(q, k, v, bias, g,
                                                        mask, scale, RATE)
        err = max(close(a, r, "bfloat16", f"kernel 8 {n} at {BWD_EDGES[i]}")
                  for n, a, r in zip(("dq", "dk", "dv", "db_part"), got, ref))
        derr = max(close(a, r, "bfloat16", f"kernel 6 d{n} at "
                         f"{BWD_EDGES[i]}")
                   for n, a, r in zip("qkv", dgot, dref))
        same_as_row_2(got, q3, k3, v3, bias, g3, scale, h, BWD_EDGES[i])
        same_as_row_4(dgot, adc.attention_dropout_bwd(
            q3, k3, v3, bias, g3, scale, h, RATE, seed), BWD_EDGES[i])
        print(f"kernels 8 / 6 B={b} Lq={lq} Lk={lk} H={h} D={d} bfloat16: "
              f"max abs diff vs twins {err:.3e} / {derr:.3e}, bit-equal to "
              "kernels 2 / 4", flush=True)
        split_ratio([natural(a) for a in dgot], q3, k3, v3, bias, g3, scale,
                    h, BWD_EDGES[i], keep=mask.transpose(0, 1).bool(),
                    row="kernel 6")
    q, k, v, bias, g, mask, scale, h, seed = args
    _, b, lq, d = q.shape
    lk = k.shape[2]
    keep = lambda: ahm.keep_mask_head_major(seed, (h, b, lq, lk), RATE,
                                            device="cuda")
    pairs = {
        "attention_head_major_fwd": (
            lambda: ahm.attention_head_major_fwd(q, k, v, bias, scale),
            lambda: ahm.attention_head_major_fwd_ref(q, k, v, bias, scale),
            False),
        "attention_head_major_bwd": (
            lambda: ahm.attention_head_major_bwd(q, k, v, bias, g, scale),
            lambda: ahm.attention_head_major_bwd_ref(q, k, v, bias, g, scale,
                                                     want_db=False),
            False),
        "attention_dropout_head_major_fwd": (
            lambda: ahm.attention_dropout_head_major_fwd(q, k, v, bias,
                                                         scale, RATE, seed),
            lambda: ahm.attention_dropout_head_major_fwd_ref(
                q, k, v, bias, scale, RATE, keep()),
            True),
        "attention_dropout_head_major_bwd": (
            lambda: ahm.attention_dropout_head_major_bwd(q, k, v, bias, g,
                                                         mask, scale, RATE),
            lambda: ahm.attention_dropout_head_major_bwd_ref(
                q, k, v, bias, g, mask, scale, RATE),
            True)}
    for name, (kern, plain, masked) in pairs.items():
        ms = kernel_ms(kern, iters=50)
        plain_ms = kernel_ms(plain, iters=50)
        ms2 = kernel_ms(kern, iters=50)
        report[name].update(
            ms=(ms + ms2) / 2, plain_ms=plain_ms, library_ms=None,
            bound=attention_bound(b, lq, lk, h, d, 2, name.endswith("_bwd"),
                                  mask=masked))
        bound_ms = report[name]["bound"][0]
        print(f"{name} (a) time {(ms + ms2) / 2:.4f} ms (runs {ms:.4f}, "
              f"{ms2:.4f}), plain twin {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms, {2 * bound_ms / (ms + ms2):.3f} of the "
              "bound", flush=True)
    # the library yardstick of rows 7 and 8: SDPA forward, and forward +
    # backward, on the same operands viewed [B, H, L, D]
    sq, sk, sv = (x.transpose(0, 1) for x in (q, k, v))
    smask = bias.view(b, 1, 1, lk).to(q.dtype)
    report["attention_head_major_fwd"]["library_ms"] = kernel_ms(
        lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask),
        iters=50)
    leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]
    report["attention_head_major_bwd"]["library_ms"] = kernel_ms(
        lambda: torch.autograd.grad(F.scaled_dot_product_attention(
            *leaves, attn_mask=smask), leaves, g.transpose(0, 1)), iters=50)
    row7, row8 = (report[n] for n in ("attention_head_major_fwd",
                                       "attention_head_major_bwd"))
    print("rows 7 / 8 library yardstick: SDPA forward "
          f"{row7['library_ms']:.4f} ms, forward + backward "
          f"{row8['library_ms']:.4f} ms; rows 7 and 8 at "
          f"{row7['bound'][0] / row7['ms']:.3f} and "
          f"{row8['bound'][0] / row8['ms']:.3f} of their bounds", flush=True)
    return report


def check_mask_kernels():
    """Phase 7: kernels 9, 14 and K10 against their twins. Row 9 at the
    shapes of phase 4 in bf16 and fp32 and at the forward's tile edges in
    bf16 (one batch row whose keys are all padded but one): its probability
    mask and hidden masks bit-equal to the twin's hash; its output within
    the tolerance of the twin's, bit-equal to row 5's on the same operands
    (one body: tensor cores in bf16, CUDA cores in fp32) and in bf16 to row
    3's in the natural layout, its probability mask to row 5's; row 14 at
    the train shape and odd ones, bit-equal to its twin and to
    ``hash_dropout``'s zero pattern; K10 forward and backward at the train
    step's dropout sites (a tail, the two embeddings, the pooled output), at
    an odd size and on views 1-7 elements past a 16-byte boundary, in both
    dtypes, bit-equal to the CPU twin of the same inputs; keep fractions
    0.9 +- 0.005 at b256; times of the three at the train shape (K10 in
    both dtypes)."""
    import torch

    from volta_tpu_torch.models.layers import hash_dropout
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc
    from volta_tpu_torch.ops import dropout_mask as dm
    from volta_tpu_torch.ops import hash_dropout as hd

    def row_9(shape, dt, seed, edge=False):
        """Row 9 at one shape against its twin, row 3 (bf16) and row 5;
        returns its max abs difference from the twin, its hidden masks'
        keep fractions and its operands."""
        b, lq, lk, h, d = shape
        q3, k3, v3, bias = attention_inputs(b, lq, lk, h, d,
                                            getattr(torch, dt), seed)
        if edge:
            bias[0, 1:] = -10000.0
        q, k, v = (head_major(x, h) for x in (q3, k3, v3))
        scale, seeds = d ** -0.5, (10 * seed, 10 * seed + 1, 10 * seed + 2)
        out, mask, hm0, hm1 = ahc.attention_dropout_hidden_masks_fwd(
            q, k, v, bias, scale, RATE, seeds[0], RATE, *seeds[1:])
        out5, mask5 = ahm.attention_dropout_head_major_fwd(
            q, k, v, bias, scale, RATE, seeds[0])
        torch.cuda.synchronize()
        same = torch.equal(out, out5)
        other = "kernel 5's"
        if dt == "bfloat16":
            same = same and torch.equal(natural(out),
                                        adc.attention_dropout_fwd(
                                            q3, k3, v3, bias, scale, h, RATE,
                                            seeds[0]))
            other = "kernels 5's and 3's"
        if not (same and torch.equal(mask, mask5)):
            raise RuntimeError(f"row 9 differs from {other} output or row "
                               f"5's mask at {shape} {dt}")
        ref, rmask, r0, r1 = ahc.attention_dropout_hidden_masks_fwd_ref(
            q, k, v, bias, scale, RATE, seeds[0], RATE, *seeds[1:])
        if not (torch.equal(mask, rmask) and torch.equal(hm0, r0)
                and torch.equal(hm1, r1)):
            raise RuntimeError(f"row 9 masks differ from the twin's at "
                               f"{shape} {dt}")
        if edge:
            err = float((out.float() - ref.float()).abs().max())
            if not (bool(torch.isfinite(out).all()) and err <= TOL[dt]):
                raise RuntimeError(f"kernel 9 disagrees at {shape}: max "
                                   f"abs diff {err:.3e}")
        else:
            err = close(out, ref, dt, "kernel 9")
        frac = [float(m.float().mean()) for m in (hm0, hm1)]
        print(f"kernel 9 B={b} Lq={lq} Lk={lk} H={h} D={d} {dt}: out "
              f"bit-equal to {other}, probability mask to kernel 5's, max "
              f"abs diff vs twin {err:.3e}, masks bit-equal to the twin's, "
              f"hidden keep fractions {frac[0]:.5f} / {frac[1]:.5f}",
              flush=True)
        return err, frac, (q, k, v, bias, scale, seeds)

    report = {}
    for i, shape in enumerate(EDGES):
        row_9(shape, "bfloat16", 380 + i, edge=True)
    for i, shape in enumerate([SERVING] + ODD):
        for dt in ("bfloat16", "float32"):
            err, frac, operands = row_9(shape, dt, 300 + i)
            if shape == SERVING:
                if max(abs(f - (1 - RATE)) for f in frac) > 0.005:
                    raise RuntimeError(f"row 9 keep fractions {frac}")
                if dt == "bfloat16":
                    report["attention_dropout_hidden_masks_fwd"] = {
                        "max_abs_err": err}
                    args = operands
    for shape in (TRAIN_ROWS, (7, 768), (33, 100), (5,), (256, 60, 768)):
        seed = 0xD00D + shape[0]
        got = dm.keep_mask(shape, RATE, seed, "cuda")
        torch.cuda.synchronize()
        ref = dm.keep_mask_ref(shape, RATE, seed, "cuda")
        ones = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
        if not (torch.equal(got, ref) and torch.equal(
                got.bool(), hash_dropout(ones, seed, RATE) != 0)):
            raise RuntimeError(f"row-14 mask differs at {shape}")
        frac = float(got.float().mean())
        print(f"kernel 14 {shape}: bit-equal to the twin and to "
              f"hash_dropout's zero pattern, keep fraction {frac:.5f}",
              flush=True)
        if shape == TRAIN_ROWS and abs(frac - (1 - RATE)) > 0.005:
            raise RuntimeError(f"row-14 keep fraction {frac}")
    report["keep_mask"] = {"max_abs_err": 0.0}
    report.update(check_hash_dropout())

    q, k, v, bias, scale, seeds = args
    h, b, lq, d = q.shape
    lk = k.shape[2]
    n, dd = TRAIN_ROWS
    pairs = {
        "attention_dropout_hidden_masks_fwd": (
            lambda: ahc.attention_dropout_hidden_masks_fwd(
                q, k, v, bias, scale, RATE, seeds[0], RATE, *seeds[1:]),
            lambda: ahc.attention_dropout_hidden_masks_fwd_ref(
                q, k, v, bias, scale, RATE, seeds[0], RATE, *seeds[1:]),
            attention_bound(b, lq, lk, h, d, 2, False, mask=True,
                            hidden=True)),
        "keep_mask": (
            lambda: dm.keep_mask(TRAIN_ROWS, RATE, 17, "cuda"),
            lambda: dm.keep_mask_ref(TRAIN_ROWS, RATE, 17, "cuda"),
            # a byte written and a hash drawn for each element
            bound(n * dd, 0, "fp32", hashed=n * dd))}
    for dt in ("bfloat16", "float32"):
        x = torch.randn(TRAIN_ROWS, device="cuda").to(getattr(torch, dt))
        for name, wrapper in (("hash_dropout_fwd", hd.hash_dropout_fwd),
                              ("hash_dropout_bwd", hd.hash_dropout_bwd)):
            # x read and the output written once each, a hash drawn for
            # each element
            pairs[name if dt == "bfloat16" else f"{name} float32"] = (
                lambda x=x, wrapper=wrapper: wrapper(x, 17, RATE),
                lambda x=x: hd.hash_dropout_ref(x, 17, RATE),
                bound(2 * x.numel() * x.element_size(), 0, "fp32",
                      hashed=x.numel()))
    for name, (kern, plain, bnd) in pairs.items():
        ms = kernel_ms(kern)
        plain_ms = kernel_ms(plain, iters=20)
        ms2 = kernel_ms(kern)
        report.setdefault(name, {"max_abs_err": 0.0}).update(
            ms=(ms + ms2) / 2, plain_ms=plain_ms, library_ms=None, bound=bnd)
        print(f"{name} time {(ms + ms2) / 2:.4f} ms (runs {ms:.4f}, "
              f"{ms2:.4f}), plain twin {plain_ms:.4f} ms (its hash "
              f"included), bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return report


def check_hash_dropout():
    """K10 (phase 7) forward and backward on the card against its twin on
    the CPU for the same inputs, bit for bit (NaN at the same places, a
    NaN's payload the card's): at a sublayer tail, the text and image
    embeddings and the pooled output of the b256 train step, at an odd
    size with NaN, Inf and -0 among its values, and on views 1-7 elements
    past a 16-byte boundary, in bf16 and fp32; keep fraction 0.9 +- 0.005
    at the tail."""
    import torch

    from volta_tpu_torch.ops import hash_dropout as hd

    def bits(t):
        return t.cpu().view(torch.int16 if t.dtype == torch.bfloat16
                            else torch.int32)

    def same_bits(got, ref):
        nan = torch.isnan(ref)
        return (torch.equal(torch.isnan(got.cpu()), nan)
                and torch.equal(bits(got)[~nan], bits(ref)[~nan]))

    shapes = [TRAIN_ROWS, (256, 23, 768), (256, 36, 768), (256, 1024),
              (3, 5, 37)]
    for i, shape in enumerate(shapes):
        for dt in ("bfloat16", "float32"):
            rng = np.random.RandomState(500 + i)
            x, g = (torch.from_numpy((rng.randn(*shape) * 3).astype(
                np.float32)).to(getattr(torch, dt)) for _ in range(2))
            if shape == (3, 5, 37):
                flat = x.view(-1)
                flat[::5], flat[1::5], flat[2::5] = np.nan, np.inf, -0.0
            seed = 0x5EED + i
            out = hd.hash_dropout_fwd(x.cuda(), seed, RATE)
            dx = hd.hash_dropout_bwd(g.cuda(), seed, RATE)
            torch.cuda.synchronize()
            if not (same_bits(out, hd.hash_dropout_ref(x, seed, RATE))
                    and same_bits(dx, hd.hash_dropout_ref(g, seed, RATE))):
                raise RuntimeError(f"K10 differs from its CPU twin at "
                                   f"{shape} {dt}")
            frac = float((out != 0).float().mean())
            print(f"kernel K10 {shape} {dt}: forward and backward bit-equal "
                  f"to the CPU twin, keep fraction {frac:.5f}", flush=True)
            if shape == TRAIN_ROWS and abs(frac - (1 - RATE)) > 0.005:
                raise RuntimeError(f"K10 keep fraction {frac}")
    n = 4099
    for dt in ("bfloat16", "float32"):
        base = torch.randn(n + 8, device="cuda").to(getattr(torch, dt))
        for off in range(1, 8):
            x = base[off:off + n]
            out = hd.hash_dropout_fwd(x, 99, RATE)
            dx = hd.hash_dropout_bwd(x, 99, RATE)
            ref = hd.hash_dropout_ref(x.cpu(), 99, RATE)
            if not (same_bits(out, ref) and same_bits(dx, ref)):
                raise RuntimeError(f"K10 differs from its CPU twin on a view "
                                   f"{off} elements past 16 bytes, {dt}")
        print(f"kernel K10 n={n} {dt} at element offsets 1-7: bit-equal to "
              "the CPU twin", flush=True)
    return {"hash_dropout_fwd": {"max_abs_err": 0.0,
                                 "shapes": f"{list(TRAIN_ROWS)} bf16"},
            "hash_dropout_bwd": {"max_abs_err": 0.0,
                                 "shapes": f"{list(TRAIN_ROWS)} bf16"}}


def matmul_inputs(shapes, seed, scale=0.5):
    import torch

    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(
        "cuda", torch.bfloat16) for s in shapes]


def check_matmul_kernels():
    """Phase 8: kernels 15 and 16 against their twins at the probes' shapes
    and at ragged ones, on the body the rule gives each (the Hopper body
    at the probes' shapes, or this raises); times at the probes' shapes,
    row 16's bias-only second leg too, beside their twins, the library and
    the bound; then both ported probes' ``main()`` at their default shapes
    with PROBE_ITERS timed calls, whose launches are the kernels' path."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.ops import matmul as mm
    from volta_tpu_torch.tools import ffn_probe, wgrad_probe

    n, h, f = PROBE
    report = {}
    # the shapes of the card tests: the probes', ragged ones that the
    # Hopper body takes (rows of 16-byte multiples) and ones that the
    # mma.sync body takes
    for tn, th, tf in (PROBE, (1000, 104, 296), (1000, 100, 300),
                       (17, 5, 9)):
        g, a = matmul_inputs([(tn, th), (tn, tf)], seed=tn)
        body = mm.matmul_body(g, a)
        got = mm.wgrad(g, a)
        torch.cuda.synchronize()
        ref = mm.wgrad_ref(g, a)
        top = float(ref.abs().max())
        # the tensor cores round each 16-deep partial sum in float32: one
        # rounding (2^-22 of the largest value) per 16 of the tn-long sum
        tol = max(1e-5, 2.0 ** -22 * -(-tn // 16)) * top
        err = float((got - ref).abs().max())
        print(f"kernel 15 n={tn} h={th} f={tf} ({body}): max abs diff vs "
              f"twin {err:.3e} (tol {tol:.3e}, |ref| max {top:.3f})",
              flush=True)
        if not (got.shape == ref.shape and err <= tol):
            raise RuntimeError(f"kernel 15 disagrees at {(tn, th, tf)}")
        if tn == n:
            if not torch.equal(got, mm.wgrad(g, a)):
                raise RuntimeError("kernel 15's split sums differ between "
                                   "two calls")
            report["wgrad"] = {"max_abs_err": err, "body": body}
            wargs = (g, a)
    for (tn, tk, tm), act in (((n, h, f), True), ((n, f, h), False),
                              ((1000, 40, 200), True),
                              ((1000, 40, 200), False),
                              ((1000, 100, 300), True),
                              ((1000, 100, 300), False), ((17, 40, 9), True)):
        x, w, b = matmul_inputs([(tn, tk), (tk, tm), (1, tm)], seed=tk)
        w = w * tk ** -0.5
        body = mm.matmul_body(x, w, b)
        got = mm.matmul_bias_act(x, w, b, act)
        torch.cuda.synchronize()
        err = close(got, mm.matmul_bias_act_ref(x, w, b, act), "bfloat16",
                    f"kernel 16 {(tn, tk, tm)} act={act}")
        print(f"kernel 16 n={tn} k={tk} m={tm} act={act} ({body}): max abs "
              f"diff vs twin {err:.3e}", flush=True)
        if (tn, tk, tm, act) == (n, h, f, True):
            report["matmul_bias_act"] = {"max_abs_err": err, "body": body}
            margs = (x, w, b)
        if (tn, tk, tm) == (n, f, h):
            leg2 = (x, w, b)
            leg2_body, leg2_err = body, err
    if {report["wgrad"]["body"], report["matmul_bias_act"]["body"],
            leg2_body} != {"wgmma"}:
        raise RuntimeError("kernels 15 and 16 must run the Hopper body at "
                           "the probes' shapes")
    g, a = wargs
    x, w, b = margs
    x2, w2, b2 = leg2
    ops = 2 * n * h * f
    try:  # the float32 output of the kernel; torch.matmul writes bf16
        torch.mm(g.t(), a, out_dtype=torch.float32)
        wgrad_lib = lambda: torch.mm(g.t(), a, out_dtype=torch.float32)
        print("row 15's yardstick: torch.mm(g.t(), a, out_dtype=float32)",
              flush=True)
    except (TypeError, RuntimeError):
        wgrad_lib = lambda: torch.matmul(g.t(), a)
        print("row 15's yardstick: torch.matmul(g.t(), a) (bf16 out; this "
              "torch's mm takes no out_dtype)", flush=True)
    pairs = {
        "wgrad": (lambda: mm.wgrad(g, a), lambda: mm.wgrad_ref(g, a),
                  wgrad_lib,
                  bound(2 * n * (h + f) + 4 * h * f, ops, "bf16 tensor")),
        "matmul_bias_act": (
            lambda: mm.matmul_bias_act(x, w, b, True),
            lambda: mm.matmul_bias_act_ref(x, w, b, True),
            lambda: F.gelu(torch.addmm(b, x, w), approximate="tanh"),
            bound(2 * (n * h + h * f + f + n * f), ops, "bf16 tensor")),
        "leg 2": (
            lambda: mm.matmul_bias_act(x2, w2, b2, False),
            lambda: mm.matmul_bias_act_ref(x2, w2, b2, False),
            lambda: torch.addmm(b2, x2, w2),
            bound(2 * (n * f + f * h + h + n * h), ops, "bf16 tensor"))}
    times = {}
    for name, (kern, plain, lib, bnd) in pairs.items():
        ms = cuda_ms(kern, iters=20)
        plain_ms = cuda_ms(plain, iters=10)
        ms2 = cuda_ms(kern, iters=20)
        lib_ms = cuda_ms(lib, iters=20)
        times[name] = dict(ms=(ms + ms2) / 2, plain_ms=plain_ms,
                           library_ms=lib_ms, bound=bnd)
        print(f"{name} n={n} h={h} f={f} time {(ms + ms2) / 2:.4f} ms "
              f"(runs {ms:.4f}, {ms2:.4f}; {ops / (ms + ms2) * 2e-9:.1f} "
              f"TFLOP/s, {bnd[0] / (ms + ms2) * 2:.3f} of the bound), "
              f"plain twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    # what holds them: row 15 on 36 clusters (72 SMs), where its plan gives
    # each cluster one whole 256 x 256 tile, against the full grid's time a
    # 64-deep step of a block's 128 x 256 tile; the first leg without its
    # gelu, against the leg with it
    steps = -(-h // 256) * -(-f // 256) * -(-n // 64)
    clusters = mm._clusters(torch.cuda.current_device())
    part = kernel_ms(lambda: mm.wgrad(g, a, clusters=36), iters=20)
    print(f"wgrad on 36 of {clusters} clusters: {part:.4f} ms, "
          f"{part / (steps / 36) * 1e3:.3f} us a step; on all: "
          f"{times['wgrad']['ms'] / (steps / clusters) * 1e3:.3f} us a "
          f"step (partials' sum included)", flush=True)
    plain_leg = kernel_ms(lambda: mm.matmul_bias_act(x, w, b, False),
                          iters=20)
    print(f"matmul_bias_act n={n} k={h} m={f} without the gelu: "
          f"{plain_leg:.4f} ms, with it {times['matmul_bias_act']['ms']:.4f}",
          flush=True)
    report["wgrad"].update(times["wgrad"])
    report["matmul_bias_act"].update(times["matmul_bias_act"])
    report["matmul_bias_act"]["leg2"] = {
        "shape": [n, f, h], "act": False, "body": leg2_body,
        "max_abs_err": leg2_err, "ms": times["leg 2"]["ms"],
        "plain_ms": times["leg 2"]["plain_ms"],
        "library_ms": times["leg 2"]["library_ms"],
        "bound_ms": times["leg 2"]["bound"][0],
        "bound_by": times["leg 2"]["bound"][1]}

    # the probes, at their default shapes: their kernel launches are the
    # path's counts (12 layers or calls, a warm call and PROBE_ITERS timed;
    # the FFN chain's cuda1 runs one kernel a call, cuda2 two)
    want = {"wgrad": 12 * (PROBE_ITERS + 1),
            "matmul_bias_act": 12 * (PROBE_ITERS + 1) * 3}
    counts = {}
    for name, probe in (("wgrad", wgrad_probe), ("matmul_bias_act",
                                                 ffn_probe)):
        reset_launches()
        probe.main(["--iters", str(PROBE_ITERS)])
        torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        if counts[name] != expect(**{name: want[name]}):
            raise RuntimeError(f"{probe.__name__} launched "
                               f"{counts[name]}, expected {want[name]}")
        torch.cuda.empty_cache()
    return report, {k: c[k] for k, c in counts.items()}


def ln_inputs(n, d, dtype, seed):
    import torch

    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    mk = lambda: torch.from_numpy(
        (rng.randn(n, d) * 2 + 0.5).astype(np.float32)).to("cuda", dt)
    vec = lambda: torch.from_numpy(
        (1 + 0.1 * rng.randn(d)).astype(np.float32)).to("cuda")
    return mk(), mk(), mk(), vec(), vec()


def check_ln_kernels():
    """Phase 6: kernels 10-13 against their twins, kernel 11's dx, dscale
    and dbias and kernel 13's do, dx, dscale and dbias bit-equal over two
    calls; their times at the train shape in bf16 and
    rows 10-11's also at the b1024 eval shape, beside the torch LayerNorm
    (``time_ln_kernels``); the host time of a call through each path."""
    import torch

    from volta_tpu_torch.models.layers import LayerNorm, hash_dropout
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import layernorm as ln

    # statistics and the float32 row sums dscale / dbias are compared as
    # float32 (1e-5 of the largest value): sums in another order
    f32 = "float32"
    report = {}
    # the b1024 eval shape, one row past a full wave of row 10's band grid
    # (every warp one row, then one warp two), the same for row 13's band
    # grid in both dtypes, and a width where 16-byte access does not apply
    edge = ln.full_wave_rows(0, 768, torch.bfloat16) + 1
    bwd_edges = [((fr.bwd_full_wave_rows(0, 768, getattr(torch, dt)) + 1,
                   768), dt) for dt in ("bfloat16", "float32")]
    for (n, d), dt in dict.fromkeys(
            LN_SHAPES + [((EVAL_ROWS, 768), "bfloat16"),
                         ((edge, 768), "bfloat16")] + bwd_edges
            + [((1000, 100), "bfloat16"), ((1000, 100), "float32")]):
        x, o, g, w, b = ln_inputs(n, d, dt, seed=n + d)
        seed = 0xBEEF + n
        y, mean, rstd = ln.layer_norm_fwd(x, w, b, EPS)
        dx, dw, db = ln.layer_norm_bwd(g, x, w, mean, rstd)
        again = ln.layer_norm_bwd(g, x, w, mean, rstd)
        fy, od, fmean, frstd = fr.dropout_residual_ln_fwd(o, x, w, b, seed,
                                                          RATE, EPS)
        fdo, fdx, fdw, fdb = fr.dropout_residual_ln_bwd(g, od, x, w, fmean,
                                                        frstd, seed, RATE)
        fagain = fr.dropout_residual_ln_bwd(g, od, x, w, fmean, frstd, seed,
                                            RATE)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b2) for a, b2 in zip((dx, dw, db), again)):
            raise RuntimeError(f"kernel 11 differs from call to call at "
                               f"{(n, d)} {dt}")
        if not all(torch.equal(a, b2) for a, b2 in
                   zip((fdo, fdx, fdw, fdb), fagain)):
            raise RuntimeError(f"kernel 13 differs from call to call at "
                               f"{(n, d)} {dt}")
        keep = adc.keep_mask(seed, (n, d), RATE, device="cuda")
        if not torch.equal(od != 0, keep) or not torch.equal(
                od != 0, hash_dropout(o, seed, RATE) != 0):
            raise RuntimeError(f"row-12 mask differs from the twin's at "
                               f"{(n, d)} {dt}")
        ry, rmean, rrstd = ln.layer_norm_fwd_ref(x, w, b, EPS)
        rdx, rdw, rdb = ln.layer_norm_bwd_ref(g, x, w, mean, rstd)
        fry, rod, frmean, frrstd = fr.dropout_residual_ln_fwd_ref(
            o, x, w, b, keep, RATE, EPS)
        if not torch.equal(od, rod):
            raise RuntimeError(f"row-12 od differs at {(n, d)} {dt}")
        frdo, frdx, frdw, frdb = fr.dropout_residual_ln_bwd_ref(
            g, od, x, w, fmean, frstd, keep, RATE)
        errs = {
            "layer_norm_fwd": max(close(y, ry, dt, "kernel 10 y"),
                                  close(mean, rmean, f32, "kernel 10 mean"),
                                  close(rstd, rrstd, f32, "kernel 10 rstd")),
            "layer_norm_bwd": max(close(dx, rdx, dt, "kernel 11 dx"),
                                  close(dw, rdw, f32, "kernel 11 dscale"),
                                  close(db, rdb, f32, "kernel 11 dbias")),
            "dropout_residual_ln_fwd": max(
                close(fy, fry, dt, "kernel 12 y"),
                close(fmean, frmean, f32, "kernel 12 mean"),
                close(frstd, frrstd, f32, "kernel 12 rstd")),
            "dropout_residual_ln_bwd": max(
                close(fdo, frdo, dt, "kernel 13 do"),
                close(fdx, frdx, dt, "kernel 13 dx"),
                close(fdw, frdw, f32, "kernel 13 dscale"),
                close(fdb, frdb, f32, "kernel 13 dbias"))}
        frac = float(keep.float().mean())
        print(f"kernels 10-13 n={n} d={d} {dt}: max abs diff vs twins "
              + " / ".join(f"{e:.3e}" for e in errs.values())
              + ", kernels 11 and 13 bit-equal over two calls, row-12 mask "
              f"and od bit-equal, keep fraction {frac:.5f}", flush=True)
        if (n, d) == TRAIN_ROWS:
            if abs(frac - (1 - RATE)) > 0.005:
                raise RuntimeError(f"row-12 keep fraction {frac}")
            if dt == "bfloat16":
                report = {k: {"max_abs_err": e} for k, e in errs.items()}
        del x, o, g, w, b, y, od, keep, fagain
        torch.cuda.empty_cache()

    for k, v in time_ln_kernels().items():
        report[k].update(v)
    # what an eval-mode sublayer tail LN(o + x) costs the host with and
    # without the LayerNorm kernels: 29 such calls make a forward
    n, d = TRAIN_ROWS
    x, o, g, w, b = ln_inputs(n, d, "bfloat16", seed=n + d)
    mean, rstd = ln.layer_norm_fwd(x, w, b, EPS)[1:]
    mods = {kern: LayerNorm(d, use_kernel=kern).cuda()
            for kern in (True, False)}
    with torch.no_grad():
        host = {"layer_norm_fwd wrapper": host_us(
                    lambda: ln.layer_norm_fwd(x, w, b, EPS)),
                "layer_norm_bwd wrapper": host_us(
                    lambda: ln.layer_norm_bwd(g, x, w, mean, rstd)),
                "tail, LayerNorm kernel": host_us(
                    lambda: mods[True](o, residual=x)),
                "tail, torch LayerNorm": host_us(
                    lambda: mods[False](o, residual=x))}
    print(f"host time per call, n={n} d={d} bf16: "
          + ", ".join(f"{k} {us:.1f} us" for k, us in host.items()),
          flush=True)
    return report


def time_ln_kernels():
    """Device times of kernels 10-13 in bf16 by ``kernel_ms`` (100 calls a
    reading, the card held busy while the host enqueues): rows 10-11 at
    each of LN_TIMED in turns kernel, torch LayerNorm, torch LayerNorm,
    kernel; rows 12-13 at the train shape twice; the twins at the train
    shape. Returns {name: {ms, plain_ms, library_ms, bound, shapes}}, ms
    and the rest at the train shape, ``shapes`` the readings of rows
    10-11 at every timed shape."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import layernorm as ln

    report = {}
    for n, d in LN_TIMED:
        x, o, g, w, b = ln_inputs(n, d, "bfloat16", seed=n + d)
        seed = 0xBEEF + n
        _, mean, rstd = ln.layer_norm_fwd(x, w, b, EPS)
        _, od, fmean, frstd = fr.dropout_residual_ln_fwd(o, x, w, b, seed,
                                                         RATE, EPS)
        keep = lambda: adc.keep_mask(seed, (n, d), RATE, device="cuda")
        # the yardstick takes weights in x's dtype: cast once, outside the
        # timing
        w16, b16 = w.to(x.dtype), b.to(x.dtype)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [d], w16, b16,
                                                           EPS)
        pairs = {
            "layer_norm_fwd": (
                lambda: ln.layer_norm_fwd(x, w, b, EPS),
                lambda: ln.layer_norm_fwd_ref(x, w, b, EPS),
                lambda: F.layer_norm(x, (d,), w16, b16, EPS)),
            "layer_norm_bwd": (
                lambda: ln.layer_norm_bwd(g, x, w, mean, rstd),
                lambda: ln.layer_norm_bwd_ref(g, x, w, mean, rstd),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    g, x, [d], lmean, lrstd, w16, b16, [True, True, True]))}
        if (n, d) == TRAIN_ROWS:
            pairs.update({
                "dropout_residual_ln_fwd": (
                    lambda: fr.dropout_residual_ln_fwd(o, x, w, b, seed,
                                                       RATE, EPS),
                    lambda: fr.dropout_residual_ln_fwd_ref(
                        o, x, w, b, keep(), RATE, EPS),
                    None),
                "dropout_residual_ln_bwd": (
                    lambda: fr.dropout_residual_ln_bwd(g, od, x, w, fmean,
                                                       frstd, seed, RATE),
                    lambda: fr.dropout_residual_ln_bwd_ref(
                        g, od, x, w, fmean, frstd, keep(), RATE),
                    None)})
        for name, (kern, plain, lib) in pairs.items():
            if lib is None:
                ms, ms2, lib_ms = kernel_ms(kern), kernel_ms(kern), None
            else:
                ms, lib1, lib2, ms2 = (kernel_ms(f) for f in
                                       (kern, lib, lib, kern))
                lib_ms = (lib1 + lib2) / 2
            bnd = row_bound(name, n, d, x.element_size())
            t = (ms + ms2) / 2
            print(f"{name} n={n} d={d} bf16 time {t:.4f} ms (runs {ms:.4f}, "
                  f"{ms2:.4f})"
                  + ("" if lib is None else
                     f", torch LayerNorm {lib_ms:.4f} ms (runs "
                     f"{lib1:.4f}, {lib2:.4f})")
                  + f", bound {bnd[0]:.4f} ms ({bnd[1]}), "
                  f"{bnd[0] / t:.3f} of the bound", flush=True)
            entry = report.setdefault(name, {"shapes": []})
            entry["shapes"].append({"n": n, "d": d, "ms": t,
                                    "library_ms": lib_ms,
                                    "bound_ms": bnd[0],
                                    "bound_share": bnd[0] / t})
            if (n, d) == TRAIN_ROWS:
                plain_ms = kernel_ms(plain, iters=20)
                print(f"{name} n={n} d={d} bf16 plain twin {plain_ms:.4f} ms"
                      + (" (mask draw included)" if lib is None else ""),
                      flush=True)
                entry.update(ms=t, plain_ms=plain_ms, library_ms=lib_ms,
                             bound=bnd)
        del x, o, g, w, b, od, mean, rstd, fmean, frstd, lmean, lrstd
        torch.cuda.empty_cache()
    return report


def host_us(fn, iters=200):
    """Host microseconds per call of ``fn`` on the host clock, the device
    left to catch up afterwards: its Python, checks, allocations and
    launches, which bound a step when they outlast its device time."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def twin_swaps():
    """(module, wrapper, twin) for every kernel of ``ops.LAUNCHES``: each
    wrapper's name is its kernel's count's key, and the twin takes its
    arguments (the dropout twins with the kernels' hash mask)."""
    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc
    from volta_tpu_torch.ops import dropout_mask as dm
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import hash_dropout as hd
    from volta_tpu_torch.ops import int8_dense as i8
    from volta_tpu_torch.ops import layernorm as ln
    from volta_tpu_torch.ops import matmul as mm
    from volta_tpu_torch.ops import nce

    def keep(q, k, heads, rate, seed):
        return adc.keep_mask(seed, (q.shape[0], heads, q.shape[1],
                                    k.shape[1]), rate, device=q.device)

    def dropout_fwd(q, k, v, bias, scale, heads, rate, seed):
        return adc.attention_dropout_fwd_ref(q, k, v, bias, scale, heads,
                                             rate, keep(q, k, heads, rate,
                                                        seed))

    def dropout_bwd(q, k, v, bias, g, scale, heads, rate, seed):
        return adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, heads,
                                             rate, keep(q, k, heads, rate,
                                                        seed))

    def head_major_dropout_fwd(q, k, v, bias, scale, rate, seed):
        keep = ahm.keep_mask_head_major(seed, (q.shape[0], q.shape[1],
                                               q.shape[2], k.shape[2]), rate,
                                        device=q.device)
        return ahm.attention_dropout_head_major_fwd_ref(
            q, k, v, bias, scale, rate, keep), keep

    def residual_fwd(o, x, w, b, seed, rate, eps):
        keep = fr.tail_keep_mask(seed, o.shape, rate, o.device)
        return fr.dropout_residual_ln_fwd_ref(o, x, w, b, keep, rate, eps)

    def residual_bwd(g, od, x, w, mean, rstd, seed, rate):
        keep = fr.tail_keep_mask(seed, x.shape, rate, x.device)
        return fr.dropout_residual_ln_bwd_ref(g, od, x, w, mean, rstd, keep,
                                              rate)

    return [(ac, "attention_fwd", ac.attention_fwd_ref),
            (ac, "attention_bwd", ac.attention_bwd_ref),
            (adc, "attention_dropout_fwd", dropout_fwd),
            (adc, "attention_dropout_bwd", dropout_bwd),
            (ahm, "attention_head_major_fwd",
             ahm.attention_head_major_fwd_ref),
            (ahm, "attention_head_major_bwd",
             ahm.attention_head_major_bwd_ref),
            (ahm, "attention_dropout_head_major_fwd", head_major_dropout_fwd),
            (ahm, "attention_dropout_head_major_bwd",
             ahm.attention_dropout_head_major_bwd_ref),
            (ln, "layer_norm_fwd", ln.layer_norm_fwd_ref),
            (ln, "layer_norm_bwd", ln.layer_norm_bwd_ref),
            (fr, "dropout_residual_ln_fwd", residual_fwd),
            (fr, "dropout_residual_ln_bwd", residual_bwd),
            (ahc, "attention_dropout_hidden_masks_fwd",
             ahc.attention_dropout_hidden_masks_fwd_ref),
            (dm, "keep_mask", dm.keep_mask_ref),
            (hd, "hash_dropout_fwd", hd.hash_dropout_ref),
            (hd, "hash_dropout_bwd", hd.hash_dropout_ref),
            (mm, "wgrad", mm.wgrad_ref),
            (mm, "matmul_bias_act", mm.matmul_bias_act_ref),
            (nce, "nce_plan", nce.nce_plan_ref),
            (nce, "nce_scores_fwd", nce.dense_neg_scores),
            (nce, "nce_scores_bwd", nce.nce_scores_bwd_ref),
            (i8, "int8_quantize", i8.quantize_ref),
            (i8, "int8_matmul", i8.int8_matmul_ref)]


@contextlib.contextmanager
def twins():
    """Every kernel's plain twin in its wrapper's place (``twin_swaps``):
    the autograd Functions and the LayerNorm look their wrappers up at call
    time, so the card runs the twins. No kernel may launch meanwhile."""
    from volta_tpu_torch.ops import LAUNCHES

    swaps = twin_swaps()
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    before = dict(LAUNCHES)
    for mod, name, twin in swaps:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)
    if LAUNCHES != before:
        raise RuntimeError("a kernel launched while the twins were in place")


@contextlib.contextmanager
def float64_attention():
    """Rows 1-9's functions with their sums in float64 in their wrappers'
    places: the forward's probabilities and every output still rounded to
    the operand dtype, only the sums taken otherwise; the dropout rows
    (3-6, 9) drop what the kernels drop (the hash masks of the same seeds).
    Inside ``twins()`` this is the plain model with other sums, whose
    distance from the twins is the noise floor that the kernels' own
    summation order is held to."""
    import torch

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc
    from volta_tpu_torch.ops import dropout_mask as dm
    from volta_tpu_torch.ops.attention import attention_probs

    def fwd(q, k, v, bias, scale, heads, factor=None):
        b, lq, hd = q.shape
        lk = k.shape[1]
        h4 = lambda x: x.view(b, -1, heads, hd // heads).double()
        probs = attention_probs(h4(q), h4(k), bias.view(b, 1, 1, lk), scale)
        if factor is not None:
            probs = probs * factor
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).double(),
                           h4(v))
        return out.to(q.dtype).reshape(b, lq, hd)

    def fwd_head_major(q, k, v, bias, scale):
        h, b, lq, d = q.shape
        out = fwd(*(natural(x) for x in (q, k, v)), bias, scale, h)
        return head_major(out, h)

    def bwd(q, k, v, bias, g, scale, heads, want_db=False):
        dq, dk, dv, db = ac.attention_bwd_ref(
            *(x.double() for x in (q, k, v, bias, g)), scale, heads, want_db)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if db is None else db.float())

    def bwd_head_major(q, k, v, bias, g, scale, want_db=False):
        dq, dk, dv, db = ahm.attention_head_major_bwd_ref(
            *(x.double() for x in (q, k, v, bias, g)), scale, want_db)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if db is None else db.float())

    def keep(q, k, heads, rate, seed):
        return adc.keep_mask(seed, (q.shape[0], heads, q.shape[1],
                                    k.shape[1]), rate, device=q.device)

    def dropout_fwd(q, k, v, bias, scale, heads, rate, seed):
        factor = keep(q, k, heads, rate, seed).double() * adc.keep_scale(rate)
        return fwd(q, k, v, bias, scale, heads, factor)

    def dropout_bwd(q, k, v, bias, g, scale, heads, rate, seed):
        grads = adc.attention_dropout_bwd_ref(
            *(x.double() for x in (q, k, v, bias, g)), scale, heads, rate,
            keep(q, k, heads, rate, seed))
        return tuple(x.to(q.dtype) for x in grads)

    def dropout_fwd_head_major(q, k, v, bias, scale, rate, seed):
        h, b, lq, d = q.shape
        mask = ahm.keep_mask_head_major(seed, (h, b, lq, k.shape[2]), rate,
                                        device=q.device)
        out = dropout_fwd(*(natural(x) for x in (q, k, v)), bias, scale, h,
                          rate, seed)
        return head_major(out, h), mask

    def dropout_bwd_head_major(q, k, v, bias, g, mask, scale, rate):
        grads = ahm.attention_dropout_head_major_bwd_ref(
            *(x.double() for x in (q, k, v, bias, g)), mask, scale, rate)
        return tuple(x.to(q.dtype) for x in grads)

    def hidden_masks_fwd(q, k, v, bias, scale, rate, seed, hidden_rate,
                         hseed0, hseed1):
        h, b, lq, d = q.shape
        out, mask = dropout_fwd_head_major(q, k, v, bias, scale, rate, seed)
        return (out, mask) + tuple(
            dm.keep_mask_ref((b, lq, h * d), hidden_rate, s, q.device)
            for s in (hseed0, hseed1))

    swaps = [(ac, "attention_fwd", fwd),
             (ahm, "attention_head_major_fwd", fwd_head_major),
             (ac, "attention_bwd", bwd),
             (ahm, "attention_head_major_bwd", bwd_head_major),
             (adc, "attention_dropout_fwd", dropout_fwd),
             (adc, "attention_dropout_bwd", dropout_bwd),
             (ahm, "attention_dropout_head_major_fwd",
              dropout_fwd_head_major),
             (ahm, "attention_dropout_head_major_bwd",
              dropout_bwd_head_major),
             (ahc, "attention_dropout_hidden_masks_fwd", hidden_masks_fwd)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def ln_kernels_off(model):
    """The model's LayerNorms on the plain torch path (both LayerNorm flags
    off) for the duration: the same weights without kernels 10-13."""
    from volta_tpu_torch.models.layers import LayerNorm

    lns = [m for m in model.modules() if isinstance(m, LayerNorm)]
    saved = [(m.use_kernel, m.fused_residual) for m in lns]
    for m in lns:
        m.use_kernel = m.fused_residual = False
    try:
        yield
    finally:
        for m, (kern, fused) in zip(lns, saved):
            m.use_kernel, m.fused_residual = kern, fused


@contextlib.contextmanager
def natural_layout(model):
    """The model's attention sublayers on the natural-layout kernels (rows
    1-4) for the duration: the same weights without the head-major copies
    and kernels 5-8."""
    from volta_tpu_torch.models.encoder import GatedAttentionSublayer

    subs = [m for m in model.modules()
            if isinstance(m, GatedAttentionSublayer)]
    saved = [m.natural for m in subs]
    for m in subs:
        m.natural = True
    try:
        yield
    finally:
        for m, nat in zip(subs, saved):
            m.natural = nat


@contextlib.contextmanager
def mask_flags_off(model):
    """The model's hidden-dropout mask flags off for the duration (no row 9,
    no row 14): the same weights drawing the same masks through
    ``hash_dropout`` or the fused tail kernels."""
    from volta_tpu_torch.models.encoder import GatedAttentionSublayer
    from volta_tpu_torch.models.layers import LayerNorm

    mods = [(m, "fuse_hidden") for m in model.modules()
            if isinstance(m, GatedAttentionSublayer)]
    mods += [(m, "pallas_mask") for m in model.modules()
             if isinstance(m, LayerNorm)]
    saved = [getattr(m, attr) for m, attr in mods]
    for m, attr in mods:
        setattr(m, attr, False)
    try:
        yield
    finally:
        for (m, attr), val in zip(mods, saved):
            setattr(m, attr, val)


WORD_STEMS = [
    "dog", "cat", "man", "woman", "ball", "car", "tree", "house", "red",
    "blue", "green", "small", "large", "play", "run", "sit", "stand", "hold",
    "wear", "table", "chair", "street", "water", "sky", "grass", "food",
    "plate", "glass", "phone", "book", "sign", "light", "window", "door",
    "hand", "head", "shirt", "hat", "bag", "bike", "bus", "train", "plane",
    "boat", "bird", "horse", "cow", "sheep", "bear", "zebra",
]


def write_synth_vocab(path, size=30522):
    """A WordPiece vocab of bert-base-uncased's size over WORD_STEMS."""
    toks = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789.,?!'-")
    toks += ["what", "where", "who", "why", "how", "is", "are", "the", "a",
             "an", "of", "on", "in", "at", "there", "color", "many", "doing",
             "and", "with", "to", "two", "three"]
    toks += WORD_STEMS
    i = 0
    while len(toks) < size:
        stem = WORD_STEMS[i % len(WORD_STEMS)]
        n = i // len(WORD_STEMS)
        toks.append(f"##{stem}{n}" if n % 2 else f"{stem}{n}")
        i += 1
    with open(path, "w") as f:
        f.write("\n".join(toks[:size]) + "\n")


def synth_boxes(rng, n, w=640, h=480):
    """``n`` random [x1, y1, x2, y2] float32 boxes in a w x h image, drawn
    as ``tools/make_synth_data.py``'s ``_boxes`` draws them."""
    x1 = rng.rand(n, 1) * (w * 0.7)
    y1 = rng.rand(n, 1) * (h * 0.7)
    x2 = x1 + 8 + rng.rand(n, 1) * (w * 0.3 - 8)
    y2 = y1 + 8 + rng.rand(n, 1) * (h * 0.3 - 8)
    return np.concatenate([x1, y1, x2, y2], 1).astype(np.float32)


def _synth_record(rng, img_id, boxes, feat_dim):
    """One features-LMDB record of the synthetic writers: pickled base64
    float32 features and boxes, in ``tools/make_synth_data.py``'s draw
    order (features, then boxes)."""
    import base64
    import pickle

    feats = (rng.randn(boxes, feat_dim) * 0.5).astype(np.float32)
    return pickle.dumps({
        "img_id": img_id, "img_h": 480, "img_w": 640, "num_boxes": boxes,
        "features": base64.b64encode(feats.tobytes()),
        "boxes": base64.b64encode(synth_boxes(rng, boxes).tobytes())})


def write_synth_features(out, images, boxes, feat_dim, rng):
    """``out``/features.lmdb: ``images`` records (image ids 1000000 on) of
    ``boxes`` x ``feat_dim`` features drawn from ``rng``, through the
    port's own LMDB writer."""
    import pickle

    from volta_tpu_torch.data import lmdbx

    keys = [str(1000000 + i).encode() for i in range(images)]
    items = [(key, _synth_record(rng, 1000000 + i, boxes, feat_dim))
             for i, key in enumerate(keys)]
    items.append((b"keys", pickle.dumps(keys)))
    lmdbx.write(os.path.join(out, "features.lmdb"), items)


def write_synth_vqa(out, images, questions, boxes, feat_dim, num_labels,
                    seed):
    """A synthetic VQA dataroot in the reference's on-disk formats, through
    the port's own LMDB writer: a features LMDB of pickled base64 float32
    records (``boxes`` x ``feat_dim``), VQA v2 question JSONs and target
    pickles for ``questions`` train and max(questions // 12, 1024) val
    questions, the answer space of ``num_labels`` and a vocab. The same
    files, byte for byte, as ``tools/make_synth_data.py vqa`` with the same
    arguments."""
    import pickle

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    write_synth_features(out, images, boxes, feat_dim, rng)
    with open(os.path.join(out, "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump({f"answer{i}": i for i in range(num_labels)}, f)
    with open(os.path.join(out, "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump([f"answer{i}" for i in range(num_labels)], f)
    os.makedirs(os.path.join(out, "cache"), exist_ok=True)
    for name, year, n_q in (("train", "2014", questions),
                            ("val", "2014", max(questions // 12, 1024))):
        qs, ts = [], []
        for q in range(n_q):
            qid = q if name == "train" else 10_000_000 + q
            iid = 1000000 + int(rng.randint(images))
            words = [WORD_STEMS[int(j)] for j in
                     rng.randint(0, len(WORD_STEMS), rng.randint(4, 9))]
            qs.append({"question_id": qid, "image_id": iid,
                       "question": "what is the " + " ".join(words) + " ?"})
            ts.append({"question_id": qid, "image_id": iid,
                       "labels": [int(rng.randint(num_labels))],
                       "scores": [1.0]})
        with open(os.path.join(
                out, f"v2_OpenEnded_mscoco_{name}{year}_questions.json"),
                "w") as f:
            json.dump({"questions": qs}, f)
        with open(os.path.join(out, "cache", f"{name}_target.pkl"),
                  "wb") as f:
            pickle.dump(ts, f)
    write_synth_vocab(os.path.join(out, "vocab.txt"))


def make_dataroot(root):
    data = os.path.join(root, "vqa")
    write_synth_vqa(data, images=256, questions=1200, boxes=36,
                    feat_dim=2048, num_labels=3129, seed=0)
    yml = os.path.join(root, "tasks.yml")
    with open(yml, "w") as f:
        f.write(f"""TASK1:
  name: VQA
  type: VL-classifier
  num_labels: 3129
  loss: BCEWithLogitLoss
  process: normal
  task_id: 1
  dataroot: {data}
  features_h5path1: {data}/features.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 23
  max_region_num: 36
  batch_size: 256
  eval_batch_size: 256
  train_split: train
  val_split: val
  lr: 0.0001
""")
    return data, yml


def write_synth_nlvr2(out, images, questions, boxes, feat_dim, seed):
    """A synthetic NLVR2 dataroot: a features LMDB keyed
    ``synth-<i>-img{0,1}`` (two images a statement) and ``train.json``
    lines of identifier / sentence / label, and a vocab; the same files,
    byte for byte, as ``tools/make_synth_data.py nlvr2`` with the same
    arguments, through the port's own LMDB writer."""
    import pickle

    from volta_tpu_torch.data import lmdbx

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    items, keys = [], []
    for i in range(images):
        for half in ("img0", "img1"):
            key = f"synth-{i}-{half}".encode()
            keys.append(key)
            items.append((key, _synth_record(rng, key.decode(), boxes,
                                             feat_dim)))
    items.append((b"keys", pickle.dumps(keys)))
    lmdbx.write(os.path.join(out, "features.lmdb"), items)
    del items
    with open(os.path.join(out, "train.json"), "w") as f:
        for k in range(questions):
            i = int(rng.randint(images))
            words = [WORD_STEMS[int(j)] for j in
                     rng.randint(0, len(WORD_STEMS), rng.randint(5, 12))]
            f.write(json.dumps({
                "identifier": f"synth-{i}-{k}",
                "sentence": "there are " + " ".join(words),
                "label": "True" if rng.rand() < 0.5 else "False",
            }) + "\n")
    write_synth_vocab(os.path.join(out, "vocab.txt"))


def write_synth_retrieval(out, images, sentences, seed):
    """Synthetic Flickr30k retrieval annotations over the VQA writer's
    features store (image ids 1000000 on): ``images`` jsonl lines of
    ``img_path`` and ``sentences`` captions, and a vocab; the same files,
    byte for byte, as ``tools/make_synth_data.py retrieval``."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(out, RETRIEVAL_ANN), "w") as f:
        for i in range(images):
            sents = []
            for _ in range(sentences):
                words = [WORD_STEMS[int(j)] for j in
                         rng.randint(0, len(WORD_STEMS), rng.randint(6, 14))]
                sents.append("a photo of " + " ".join(words))
            f.write(json.dumps({"img_path": f"{1000000 + i}.jpg",
                                "sentences": sents}) + "\n")
    write_synth_vocab(os.path.join(out, "vocab.txt"))


def write_synth_refcoco(out, images, refs_per_image, boxes, feat_dim, seed):
    """A synthetic RefCOCO+ dataroot: ``refs(unc).p`` (every ref in the
    ``train`` split), ``instances.json`` (each ref's box, one of the
    detector boxes, so the IoU target has a 1.0 slot), a detector-features
    LMDB keyed by image id, and a vocab; the same files, byte for byte, as
    ``tools/make_synth_data.py refcoco`` with the same arguments."""
    import base64
    import pickle

    from volta_tpu_torch.data import lmdbx

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    refs, anns, items, keys = [], [], [], []
    sent_id = 0
    for i in range(images):
        image_id = 3000000 + i
        det_boxes = synth_boxes(rng, boxes)
        key = str(image_id).encode()
        keys.append(key)
        feats = (rng.randn(boxes, feat_dim) * 0.5).astype(np.float32)
        items.append((key, pickle.dumps({
            "img_id": image_id, "img_h": 480, "img_w": 640,
            "num_boxes": boxes,
            "features": base64.b64encode(feats.tobytes()),
            "boxes": base64.b64encode(det_boxes.tobytes())})))
        for r in range(refs_per_image):
            bb = det_boxes[int(rng.randint(boxes))]
            ann_id = image_id * 10 + r
            anns.append({"id": ann_id,
                         "bbox": [float(bb[0]), float(bb[1]),
                                  float(bb[2] - bb[0]),
                                  float(bb[3] - bb[1])]})
            words = [WORD_STEMS[int(j)] for j in
                     rng.randint(0, len(WORD_STEMS), rng.randint(2, 6))]
            refs.append({"split": "train", "ann_id": ann_id,
                         "image_id": image_id, "ref_id": ann_id,
                         "sentences": [{"raw": "the " + " ".join(words)}],
                         "sent_ids": [sent_id]})
            sent_id += 1
    items.append((b"keys", pickle.dumps(keys)))
    lmdbx.write(os.path.join(out, "refcoco+_feat.lmdb"), items)
    with open(os.path.join(out, "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(out, "instances.json"), "w") as f:
        json.dump({"annotations": anns}, f)
    write_synth_vocab(os.path.join(out, "vocab.txt"))


def make_task_dataroot(root, vqa_dir):
    """Phase 16's dataroots and task yml: TASK8 (RetrievalFlickr30k over the
    VQA store's first 64 images, 5 captions each), TASK10 (refcoco+, 1026
    refs on 342 images) and TASK12 (NLVR2, 1024 statements on 128 image
    pairs), at full feature width (36 boxes x 2048), with
    ``ctrl_trainval_tasks.yml``'s fields. The writers make one split, so
    each task's val split is its train split (retrieval's caches it under
    the name ``val``)."""
    ret, ref, nl = (os.path.join(root, n) for n in
                    ("flickr30k", "refcoco+", "nlvr2"))
    write_synth_retrieval(ret, images=64, sentences=5, seed=0)
    write_synth_refcoco(ref, images=342, refs_per_image=3, boxes=36,
                        feat_dim=2048, seed=0)
    write_synth_nlvr2(nl, images=128, questions=1024, boxes=36,
                      feat_dim=2048, seed=0)
    yml = os.path.join(root, "task_heads.yml")
    with open(yml, "w") as f:
        f.write(f"""TASK8:
  name: RetrievalFlickr30k
  type: VL-logit
  num_labels: 1
  loss: CrossEntropyLoss
  process: retrieval
  task_id: 8
  dataroot: {ret}
  features_h5path1: {vqa_dir}/features.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: {ret}/{RETRIEVAL_ANN}
  val_annotations_jsonpath: {ret}/{RETRIEVAL_ANN}
  max_seq_length: 30
  max_region_num: 36
  batch_size: 64
  train_split: train
  val_split: val
  lr: 0.00002
TASK10:
  name: refcoco+
  type: V-logit
  loss: BCEWithLogitLoss
  process: normal
  task_id: 10
  dataroot: {ref}
  features_h5path1: {ref}/refcoco+_feat.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 20
  max_region_num: 36
  batch_size: 256
  eval_batch_size: 1024
  train_split: train
  val_split: train
  lr: 0.0001
TASK12:
  name: NLVR2
  type: VL-binary-classifier
  num_labels: 2
  loss: BCEWithLogitLoss
  process: nlvr
  task_id: 12
  dataroot: {nl}
  features_h5path1: {nl}/features.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 40
  max_region_num: 36
  batch_size: 64
  eval_batch_size: 512
  train_split: train
  val_split: train
  lr: 0.00001
""")
    return yml


def task_argmax(ttype, logits, info):
    """The answers a head's logits give: the region (V-logit), the option
    (VL-logit) or the class."""
    if ttype.startswith("V-logit"):
        return logits[..., 0].argmax(1)
    if ttype == "VL-logit":
        return logits.reshape(info["batch_size"], -1).argmax(1)
    return logits.argmax(1)


def hold_task_logits(task_cfg, task, batch_np, tag, config=CONFIG):
    """One eval batch of ``task`` through ``config`` with the kernels
    and with the twins, bf16 and, on the same weights, fp32: fp32 logits
    within LOGIT_TOL_FP32; bf16 within NOISE_FACTOR times the twins'
    distance from the twins with float64 attention sums (at least
    LOGIT_TOL); the answers that flip, reported. Returns the bf16 model."""
    import torch

    from volta_tpu_torch.eval_step import make_task_eval_step, to_device

    ttype = task_cfg[task]["type"]
    one = to_device(batch_np, "cuda")
    for dtype in ("float32", "bfloat16"):
        model = build_model(task_cfg, dtype, config, task=task).eval()
        fn = make_task_eval_step(model, task_cfg, task)
        out = fn(one)
        kern = out["prediction"].float()
        with twins():
            plain = fn(one)["prediction"].float()
            with float64_attention():
                alt = fn(one)["prediction"].float()
        ans = [task_argmax(ttype, x, out["info"]) for x in (kern, plain, alt)]
        n = int(ans[0].numel())
        diff = float((kern - plain).abs().max())
        noise = float((plain - alt).abs().max())
        flips = int((ans[0] != ans[1]).sum())
        noise_flips = int((ans[2] != ans[1]).sum())
        tol = LOGIT_TOL_FP32 if dtype == "float32" \
            else max(LOGIT_TOL, NOISE_FACTOR * noise)
        print(f"{tag} logits {tuple(kern.shape)} {dtype} kernels vs plain "
              f"twins: max abs diff {diff:.3e} (tol {tol:.3e}; twins vs "
              f"float64 attention sums {noise:.3e}); answers flipped "
              f"{flips} of {n} (twins vs float64 sums {noise_flips}); "
              f"|logits| max {float(kern.abs().max()):.3f}", flush=True)
        if not bool(torch.isfinite(kern).all()):
            raise RuntimeError(f"{tag}: non-finite {dtype} logits")
        if diff > tol:
            raise RuntimeError(f"{tag}: the {dtype} kernel model disagrees "
                               "with the plain twins")
        if dtype == "float32":
            del model, fn
    return model


# phases 12 (but its default run), 15, 16 and 20 at 4 of ctrl_uniter_base's
# 12 layers (its first 8 sublayers), their launches from the cut config's
# plan; the full config's plan is held to 12 attention and 27 K10
# launches a forward
UNITER_CUT = tuple(range(8))


def uniter_cut(root, src=CONFIG):
    """ctrl_uniter_base (or its flagged copy at ``src``) cut to
    UNITER_CUT, after the full config's plan is checked; the cut's path
    and its ``plan_counts``."""
    from volta_tpu_torch.config import VoltaConfig

    full = plan_counts(VoltaConfig.from_json_file(src))
    if (full["attn"], full["k10"], full["k10_bwd"]) != (12, 27, 27):
        raise RuntimeError(f"{src}'s plan gives {full}")
    path = cut_config(root, os.path.basename(src)[:-len(".json")],
                      UNITER_CUT, src=src)
    cut = plan_counts(VoltaConfig.from_json_file(path))
    print(f"{os.path.basename(path)}: {len(UNITER_CUT) // 2} layers, "
          f"{cut['attn']} attention and {cut['k10']} K10 launches a forward "
          f"(full depth {full['attn']} and {full['k10']})", flush=True)
    return path, cut


def run_task(root, data_dir, yml, power, task, tag, eval_cli,
             config=CONFIG):
    """Phase 16 (and 18 (a)) for one task of ``yml`` with ``config``, its
    launches counted from its plan (``plan_counts``): the eval CLI
    (``eval_cli``) over
    the val split at the yml's eval batch, with exact launches and one
    record an item; the train CLI, one epoch at the yml's batch with the
    config's dropout and its val loop, with exact launches and finite
    losses; one eval batch held to the twins (``hold_task_logits``); eval
    items/s at that batch and train ms/step with peak memory, bf16, one
    timed run each (three, and a profile of the step, before phase 22;
    PERF.md keeps their numbers). Returns the launches of the runs and the
    rates."""
    import torch

    from volta_tpu_torch import eval_task, train_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import warmup_linear_schedule
    from volta_tpu_torch.task_utils import load_dataset, load_task_config, \
        process_batch

    task_cfg = load_task_config(yml)
    key = "TASK" + task
    tc = task_cfg[key]
    cfg = task_config(config, tc)
    counts = plan_counts(cfg)
    attn = counts["attn"]
    out = {}
    if eval_cli:
        argv = ["--config_file", config, "--tasks_config_file", yml,
                "--task", task, "--vocab_file",
                os.path.join(data_dir, "vocab.txt"),
                "--output_dir", os.path.join(root, f"results_{tag}"),
                "--num_workers", "4", "--compute_dtype", "bfloat16",
                "--device", "cuda", "--seed", "0"]
        reset_launches()
        t0 = time.time()
        summary = eval_task.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        with open(summary["out_file"]) as f:
            results = json.load(f)
        n_items = summary["n"]
        n_batches = -(-n_items // tc["eval_batch_size"])
        print(f"eval_task.main ({tag}): {n_items} items in {n_batches} "
              f"batches of {tc['eval_batch_size']}, {wall:.1f} s wall (data "
              f"and model set-up included), loss {summary['loss']:.4f} "
              f"score {summary['score']:.4f}, {len(results)} records, "
              f"launches {launches}", flush=True)
        want = expect(attention_fwd=attn * n_batches)
        if launches != want:
            raise RuntimeError(f"{tag} eval launches {launches}, expected "
                               f"{want}")
        if summary["nonfinite_batches"] or len(results) != n_items:
            raise RuntimeError(f"{tag}: {summary['nonfinite_batches']} "
                               f"non-finite batches, {len(results)} records "
                               f"for {n_items} items")
        out["eval"] = launches

    argv = train_argv(root, data_dir, yml, config, 1, tag, task=task)
    data = load_dataset(train_task.parse_args(argv), cfg, task_cfg, task)
    n_train, n_val = len(data["train_loader"]), len(data["val_loader"])
    reset_launches()
    t0 = time.time()
    summary = train_task.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    steps, losses = summary["steps"], summary["train_losses"]
    print(f"train_task.main ({tag}): {steps} steps at b{tc['batch_size']}, "
          f"{n_val} val batches, {wall:.1f} s wall (data and model set-up "
          f"included), losses {[round(l, 4) for l in losses]}, val scores "
          f"{summary['val_scores']}, launches {launches}", flush=True)
    want = expect(attention_dropout_fwd=attn * steps,
                  attention_dropout_bwd=counts["attn_bwd"] * steps,
                  attention_fwd=attn * n_val, **k10_of(counts, steps))
    if steps != n_train or len(losses) != steps \
            or not np.all(np.isfinite(losses)) \
            or len(summary["val_scores"]) != 1:
        raise RuntimeError(f"{tag}: {steps} steps, losses {losses}")
    if launches != want:
        raise RuntimeError(f"{tag} train launches {launches}, expected "
                           f"{want}")
    out["train"] = launches

    # an eval batch of the yml's eval size from the val loader
    per = tc.get("eval_batch_size", tc["batch_size"]) // tc["batch_size"]
    val = [b for _, b in zip(range(per), data["val_loader"])]
    eval_np = concat_batches([{k: v for k, v in b.items()
                               if isinstance(v, np.ndarray)} for b in val])
    model = hold_task_logits(task_cfg, key, eval_np, tag, config)
    step = make_task_eval_step(model, task_cfg, key)
    batch = to_device(eval_np, "cuda")
    items = int(eval_np["question"].shape[0])
    rows = int(process_batch(tc, batch)[0]["input_ids"].shape[0])
    runs = [throughput(step, batch, iters=10)]
    rate = float(np.median([r for r, _ in runs]))
    print(f"{tag} eval forward b{items} ({rows} rows): median {rate:.1f} "
          f"items/s, {rate * rows / items:.1f} rows/s (runs "
          f"{', '.join(f'{r:.1f}' for r, _ in runs)}), peak "
          f"{max(m for _, m in runs):.2f} GiB [{power}]", flush=True)

    model.train()
    state, tstep = new_step(model, task_cfg,
                            warmup_linear_schedule(1e-4, 10, 1000), task=key)
    train_np = next(iter(data["train_loader"]))
    tbatch = to_device({k: v for k, v in train_np.items()
                        if isinstance(v, np.ndarray)}, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: tstep(state, tbatch), iters=10, warmup=2)
    print(f"{tag} train step b{tc['batch_size']} bf16: {ms:.2f} ms/step, "
          f"{tc['batch_size'] / ms * 1e3:.1f} items/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{power}]",
          flush=True)
    out["rates"] = {"eval_items_per_s": rate, "train_ms": ms}
    return out


def check_task_kernels():
    """Phase 16 (a): rows 1-4 against their twins at the (B, L) the task
    paths give them, bf16 and fp32, as phases 3 and 4 hold them: row 1 at
    the eval shapes, rows 1-4 at the train shapes (``TASK_SHAPES``); rows 1
    and 3 within TOL, rows 2 and 4 within two bf16 ulps of the largest
    value (fp32 1e-5 relative), row 3's mask bit-equal to the twin's hash
    with its keep fraction 0.9 +- 0.005. In bf16, each row's device time
    there (``kernel_ms``) beside its bound (its twin's untimed, and L 64
    and 65, the tile edge, untimed since phase 22: PERF.md, PR 15)."""
    import torch

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

    h, d = 12, 64
    scale = d ** -0.5
    for i, (b, l, train) in enumerate(TASK_SHAPES):
        for dt in ("bfloat16", "float32"):
            q, k, v, bias = attention_inputs(b, l, l, h, d,
                                             getattr(torch, dt), 1600 + i)
            g = torch.randn_like(q)
            seed = 1600 + i
            out1 = ac.attention_fwd(q, k, v, bias, scale, h)
            torch.cuda.synchronize()
            ref1 = ac.attention_fwd_ref(q, k, v, bias, scale, h)
            err1 = float((out1.float() - ref1.float()).abs().max())
            if not bool(torch.isfinite(out1).all()) or err1 > TOL[dt]:
                raise RuntimeError(f"row 1 disagrees at B={b} L={l} {dt}: "
                                   f"{err1:.3e}")
            del ref1
            line = f"row 1 {err1:.3e}"
            if train:
                got2 = ac.attention_bwd(q, k, v, bias, g, scale, h)
                out3, mask = adc.attention_dropout_fwd(
                    q, k, v, bias, scale, h, RATE, seed, return_mask=True)
                got4 = adc.attention_dropout_bwd(q, k, v, bias, g, scale, h,
                                                 RATE, seed)
                torch.cuda.synchronize()
                keep = adc.keep_mask(seed, (b, h, l, l), RATE, device="cuda")
                if not torch.equal(mask, keep):
                    raise RuntimeError(f"row-3 mask differs from the twin's "
                                       f"at B={b} L={l} {dt}")
                err2 = max(close(a, r, dt, f"row 2 d{n} at B={b} L={l}")
                           for n, a, r in zip("qkv", got2,
                                              ac.attention_bwd_ref(
                                                  q, k, v, bias, g, scale, h,
                                                  want_db=False)))
                ref3 = adc.attention_dropout_fwd_ref(q, k, v, bias, scale, h,
                                                     RATE, keep)
                err3 = float((out3.float() - ref3.float()).abs().max())
                if not bool(torch.isfinite(out3).all()) or err3 > TOL[dt]:
                    raise RuntimeError(f"row 3 disagrees at B={b} L={l} "
                                       f"{dt}: {err3:.3e}")
                err4 = max(close(a, r, dt, f"row 4 d{n} at B={b} L={l}")
                           for n, a, r in zip(
                               "qkv", got4, adc.attention_dropout_bwd_ref(
                                   q, k, v, bias, g, scale, h, RATE, keep)))
                frac = float(mask.float().mean())
                if abs(frac - (1 - RATE)) > 0.005:
                    raise RuntimeError(f"keep fraction {frac} at B={b} "
                                       f"L={l}")
                line += (f", row 2 {err2:.3e}, row 3 {err3:.3e} (mask "
                         f"bit-equal, keep fraction {frac:.5f}), row 4 "
                         f"{err4:.3e}")
                del got2, out3, mask, got4, keep, ref3
            print(f"B={b} L={l} H={h} D={d} {dt} max abs diff vs twins: "
                  f"{line}", flush=True)
            if dt == "bfloat16":
                # the twins' times here: PERF.md, PR 15
                time_task_rows(q, k, v, bias, g, scale, h, seed, train,
                               twins=False)
            del q, k, v, bias, g, out1


def time_task_rows(q, k, v, bias, g, scale, h, seed, train, twins=True):
    """Device ms (``kernel_ms``) of row 1 and, for a train shape, rows 2-4
    on these bf16 operands, beside their twins' (``twins``), their bounds
    and SDPA's forward (row 1) and forward + backward (row 2) on the same
    operands and additive mask."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

    b, lq, lk, d = q.shape[0], q.shape[1], k.shape[1], q.shape[2] // h
    sq, sk, sv, smask = sdpa_operands(q, k, v, bias, h)
    leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]
    sg = g.view(b, lq, h, d).transpose(1, 2)
    library = {
        "row 1": lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask),
        "row 2": lambda: torch.autograd.grad(F.scaled_dot_product_attention(
            *leaves, attn_mask=smask), leaves, sg)}
    keep = lambda: adc.keep_mask(seed, (b, h, lq, lk),  # noqa: E731
                                 RATE, device="cuda")
    rows = [("row 1", lambda: ac.attention_fwd(q, k, v, bias, scale, h),
             lambda: ac.attention_fwd_ref(q, k, v, bias, scale, h), False)]
    if train:
        rows += [
            ("row 2", lambda: ac.attention_bwd(q, k, v, bias, g, scale, h),
             lambda: ac.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                          want_db=False), True),
            ("row 3", lambda: adc.attention_dropout_fwd(
                q, k, v, bias, scale, h, RATE, seed),
             lambda: adc.attention_dropout_fwd_ref(
                 q, k, v, bias, scale, h, RATE, keep()), False),
            ("row 4", lambda: adc.attention_dropout_bwd(
                q, k, v, bias, g, scale, h, RATE, seed),
             lambda: adc.attention_dropout_bwd_ref(
                 q, k, v, bias, g, scale, h, RATE, keep()), True)]
    for name, kern, plain, backward in rows:
        ms = kernel_ms(kern, iters=30)
        plain_ms = kernel_ms(plain, iters=5) if twins else None
        lib_ms = kernel_ms(library[name], iters=30) \
            if name in library else None
        bnd = attention_bound(b, lq, lk, h, d, 2, backward)
        where = f"L={lq}" if lq == lk else f"Lq={lq} Lk={lk}"
        print(f"{name} B={b} {where} H={h} D={d} bf16: {ms:.4f} ms, plain "
              "twin "
              f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}"
              f", SDPA "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"{' (forward + backward)' if name == 'row 2' else ''}, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.3f} of "
              "the bound", flush=True)


def write_config(root, name, base=CONFIG, **fields):
    """A copy of ctrl_uniter_base's config (or ``base``) with ``fields``
    replaced, in ``root``; the repo's configs stay as they are."""
    from volta_tpu_torch.config import VoltaConfig

    cfg = VoltaConfig.from_json_file(base)
    for key, val in fields.items():
        if not hasattr(cfg, key):
            raise KeyError(key)
        setattr(cfg, key, val)
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(cfg.to_json_string())
    if VoltaConfig.from_json_file(path).to_dict() != cfg.to_dict():
        raise RuntimeError(f"{path} does not load as written")
    return path


def concat_batches(batches):
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


def throughput(step, batch, iters):
    """pairs/s of the eval step on a batch already on the card, and the
    peak device memory of the run."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch), iters=iters, warmup=2)
    n = int(batch["question"].shape[0])
    return n / (ms / 1e3), torch.cuda.max_memory_allocated() / 2**30


def run_slice(root, data_dir, yml, power, config, tag, per_batch, routes,
              ln_flags=False, layout_check=False, profile=False):
    """Phases 9-11: the eval CLI on synthetic VQA at full width with
    ``config``. ``per_batch`` holds the launches of one batch; ``routes``
    gives, for the model, two named context managers whose eval throughputs
    are compared in turns (ab_turns); ``ln_flags`` says that the path runs
    the LayerNorm kernels; ``layout_check`` holds the head-major model's
    logits, bf16 and fp32, to the same weights on the natural layout;
    ``profile`` gives the device time of the b256 and b1024
    forwards by kernel under the first route. Returns the launches and the
    rates."""
    import torch

    from volta_tpu_torch import eval_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    argv = ["--config_file", config, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, f"results_{tag}"),
            "--num_workers", "4", "--compute_dtype", "bfloat16",
            "--device", "cuda", "--seed", "0"]

    reset_launches()
    t0 = time.time()
    summary = eval_task.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)

    args = eval_task.parse_args(argv)
    model, task_cfg, task, data = eval_task.setup(args)
    n_q = len(data["dataset"])
    n_batches = -(-n_q // 256)
    print(f"eval_task.main ({tag}): {summary['n']} questions in {n_batches} "
          f"batches, {wall:.1f} s wall (data and model set-up included), "
          f"loss {summary['loss']:.4f} score {summary['score']:.4f}, "
          f"kernel launches {launches}", flush=True)
    want = expect(**{k: c * n_batches for k, c in per_batch.items()})
    if launches != want:
        raise RuntimeError(f"eval launches {launches}, expected {want}")
    if summary["nonfinite_batches"]:
        raise RuntimeError("non-finite logits in "
                           f"{summary['nonfinite_batches']} batches")
    with open(summary["out_file"]) as f:
        results = json.load(f)
    qids = sorted(r["question_id"] for r in results)
    want_q = sorted(int(e["question_id"]) for e in data["dataset"].entries)
    if qids != want_q or summary["n"] != n_q:
        raise RuntimeError(f"{len(results)} answers for {n_q} questions")

    step = make_task_eval_step(model, task_cfg, task)
    batches = list(data["loader"])
    one = to_device(batches[0], "cuda")
    # the same weights in float32: there every kernel of the path but the
    # LayerNorm kernels is bit-equal to its twin
    args32 = eval_task.parse_args(argv + ["--compute_dtype", "float32"])
    model32 = eval_task.setup(args32)[0]
    models = [("bfloat16", model, step),
              ("float32", model32, make_task_eval_step(model32, task_cfg,
                                                       task))]
    for dtype, net, fn in models:
        kernel_logits = fn(one)["prediction"].float()
        with twins():
            plain_logits = fn(one)["prediction"].float()
        # the noise floor: the plain model against itself with other sums,
        # its attention summing in float64 (and, with the LayerNorm kernels,
        # the torch LayerNorm path beside the kernels)
        refs = {"float64 attention sums": (twins, float64_attention)}
        if ln_flags:
            refs["the torch LayerNorm path"] = (lambda: ln_kernels_off(net),)
        noise, agree_noise = 0.0, 1.0
        for name, ctxs in refs.items():
            with contextlib.ExitStack() as stack:
                for ctx in ctxs:
                    stack.enter_context(ctx())
                alt = fn(one)["prediction"].float()
            n = float((plain_logits - alt).abs().max())
            a = float((alt.argmax(1) == plain_logits.argmax(1)).float()
                      .mean())
            print(f"logits b256 ({tag}, {dtype}) plain twins vs {name}: "
                  f"max abs diff {n:.3e}, answers agree {a:.4f}", flush=True)
            noise, agree_noise = max(noise, n), min(agree_noise, a)
        diff = float((kernel_logits - plain_logits).abs().max())
        agree = float((kernel_logits.argmax(1) == plain_logits.argmax(1))
                      .float().mean())
        # the float32 model is held to LOGIT_TOL_FP32. In bf16 the kernels
        # sum in another order than their twins (the tensor-core attention,
        # the LayerNorm kernels), so no bit-equality holds there: the bf16
        # model may stray from the twins no further than NOISE_FACTOR times
        # the noise floor, with LOGIT_TOL as the floor of that limit, and
        # flip no more than AGREE_SLACK answers beyond it
        if dtype == "float32":
            tol, min_agree = LOGIT_TOL_FP32, 0.0
        else:
            tol = max(LOGIT_TOL, NOISE_FACTOR * noise)
            min_agree = agree_noise - AGREE_SLACK / kernel_logits.shape[0]
        print(f"logits b256 ({tag}, {dtype}) kernels vs plain twins: max abs "
              f"diff {diff:.3e} (tol {tol:.3e}; LOGIT_TOL {LOGIT_TOL:g}), "
              f"answers agree {agree:.4f} (min {min_agree:.4f}); |logits| "
              f"max {float(kernel_logits.abs().max()):.3f}", flush=True)
        if not bool(torch.isfinite(kernel_logits).all()):
            raise RuntimeError(f"non-finite {dtype} logits")
        if not (diff <= tol and agree >= min_agree):
            raise RuntimeError("kernel model disagrees with the plain twins")
        if layout_check:
            # both layouts run one body a row and the same ops around it:
            # their logits are equal to the bit
            with natural_layout(net):
                nat_logits = fn(one)["prediction"].float()
            ldiff = float((kernel_logits - nat_logits).abs().max())
            print(f"logits b256 ({tag}, {dtype}) head-major vs natural "
                  f"layout: max abs diff {ldiff:.3e} (tol 0)", flush=True)
            if ldiff != 0.0:
                raise RuntimeError("head-major model disagrees with the "
                                   "natural layout")

    (name_a, route_a), (name_b, route_b) = routes(model)
    rates = {}
    sized = ((256, one),
             (1024, to_device(concat_batches(batches[:4]), "cuda")))
    for bsz, batch in sized:
        runs = {name_a: [], name_b: []}
        for name, route in ab_turns(name_a, route_a, name_b, route_b):
            with route():
                runs[name].append(throughput(step, batch, iters=10))
        for name, rs in runs.items():
            rate = float(np.median([r for r, _ in rs]))
            rates[(bsz, name)] = rate
            print(f"eval forward b{bsz} {name}: median {rate:.1f} pairs/s "
                  f"(runs {', '.join(f'{r:.1f}' for r, _ in rs)}), peak "
                  f"{max(m for _, m in rs):.2f} GiB [{power}]", flush=True)
    print(f"eval end to end ({tag}, eval_task.main, b256, 1024 questions): "
          f"{summary['n'] / wall:.1f} pairs/s [{power}]", flush=True)
    if profile:
        for bsz, batch in sized:
            profile_device(lambda: step(batch),
                           bsz / rates[(bsz, name_a)] * 1e3,
                           f"eval forward b{bsz}, {tag}, {name_a}")
    return launches, rates


def train_argv(root, data_dir, yml, config, epochs, tag, task="1"):
    return ["--config_file", config, "--tasks_config_file", yml,
            "--task", task, "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, f"save_{tag}"),
            "--logdir", os.path.join(root, f"logs_{tag}"),
            "--num_train_epochs", str(epochs), "--num_workers", "4",
            "--compute_dtype", "bfloat16", "--clip_grad_norm", "1.0",
            "--device", "cuda", "--seed", "0"]


def run_train(root, data_dir, yml, flagged, hm, fuse, pmask, free, hm_free):
    """Phase 12: the train CLI at full width, with the config's dropout
    (two epochs at full depth), then at 4 layers (``uniter_cut``) with
    its dropout rates set to 0, with the LayerNorm flags on
    (``flagged``), with the head-major attention (``hm``) with the
    config's dropout and with none (``free``, ``hm_free``: the configs
    with dropout rates 0), and with each hidden-mask flag (``fuse``:
    fuse_hidden_dropout, ``pmask``: use_pallas_dropout_mask), each run's
    launches from its config's plan. Returns the launches of each run."""
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    cfg = VoltaConfig.from_json_file(CONFIG)
    out = {}
    for tag, config, epochs in (("dropout", CONFIG, 2),
                                ("dropout_free", free, 1),
                                ("flagged", flagged, 1),
                                ("head_major", hm, 1),
                                ("head_major_dropout_free", hm_free, 1),
                                ("hidden_masks", fuse, 1),
                                ("keep_mask", pmask, 1)):
        counts = plan_counts(cfg)
        if tag != "dropout":
            config, counts = uniter_cut(root, config)
        attn, tails, sites = counts["attn"], counts["tails"], counts["k10"]
        argv = train_argv(root, data_dir, yml, config, epochs, tag)
        data = load_dataset(train_task.parse_args(argv), cfg,
                            load_task_config(yml), "1")
        n_train, n_val = len(data["train_loader"]), len(data["val_loader"])
        reset_launches()
        t0 = time.time()
        summary = train_task.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        steps, losses = summary["steps"], summary["train_losses"]
        with open(os.path.join(summary["log_dir"], "out.txt")) as f:
            val_lines = [l.strip() for l in f if " VAL epoch " in l]
        print(f"train_task.main ({tag}): {epochs} epochs, {steps} steps at "
              f"b256, {wall:.1f} s wall (data and model set-up included), "
              f"losses {[round(l, 4) for l in losses]}, launches "
              f"{launches}", flush=True)
        for line in val_lines:
            print("  " + line, flush=True)
        if steps != epochs * n_train or len(losses) != steps:
            raise RuntimeError(f"{steps} steps, {len(losses)} losses")
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"train losses {losses}")
        if len(val_lines) != epochs:
            raise RuntimeError(f"{len(val_lines)} VAL lines")
        val = epochs * n_val
        # the 5 LayerNorms outside the tails (embeddings, classifier) run
        # row 10 in a step; an eval forward runs every LayerNorm on it
        want = {
            "dropout": expect(attention_dropout_fwd=attn * steps,
                              attention_dropout_bwd=attn * steps,
                              attention_fwd=attn * val,
                              **k10(sites * steps)),
            "dropout_free": expect(attention_fwd=attn * (steps + val),
                                   attention_bwd=attn * steps,
                                   **k10(K10_POOLED * steps)),
            "flagged": expect(attention_dropout_fwd=attn * steps,
                              attention_dropout_bwd=attn * steps,
                              attention_fwd=attn * val,
                              layer_norm_fwd=5 * steps + (5 + tails) * val,
                              layer_norm_bwd=5 * steps,
                              dropout_residual_ln_fwd=tails * steps,
                              dropout_residual_ln_bwd=tails * steps,
                              **k10(K10_FLAGGED * steps)),
            "head_major": expect(
                attention_dropout_head_major_fwd=attn * steps,
                attention_dropout_head_major_bwd=attn * steps,
                attention_head_major_fwd=attn * val,
                **k10(sites * steps)),
            "head_major_dropout_free": expect(
                attention_head_major_fwd=attn * (steps + val),
                attention_head_major_bwd=attn * steps,
                **k10(K10_POOLED * steps)),
            "hidden_masks": expect(
                attention_dropout_hidden_masks_fwd=attn * steps,
                attention_dropout_head_major_bwd=attn * steps,
                attention_fwd=attn * val, **k10(K10_FLAGGED * steps)),
            "keep_mask": expect(attention_dropout_fwd=attn * steps,
                                attention_dropout_bwd=attn * steps,
                                keep_mask=tails * steps,
                                attention_fwd=attn * val,
                                **k10(K10_FLAGGED * steps))}[tag]
        if launches != want:
            raise RuntimeError(f"{tag} launches {launches}, expected {want}")
        out[tag] = launches
    return out, data


def task_config(config, tc):
    """``config`` with the task's ``fusion_method``, as the CLIs apply it
    (train_task.py:185-187, eval_task.py:163-165)."""
    from volta_tpu_torch.config import VoltaConfig

    cfg = VoltaConfig.from_json_file(config)
    if tc.get("fusion_method"):
        cfg.fusion_method = tc["fusion_method"]
    return cfg


def build_model(task_cfg, dtype, config=CONFIG, seed=0, task="TASK1"):
    """ctrl_uniter_base (or ``config``) with ``task``'s head (VQA's by
    default) on the card, random weights from ``seed``."""
    import torch

    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.models.layers import init_weights

    cfg = task_config(config, task_cfg[task])
    cfg.compute_dtype = dtype
    model = VoltaForVLTasks(cfg, task_cfg, (task,))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.cuda()


def new_step(model, task_cfg, lr, task="TASK1"):
    """A fresh clip + AdamW over ``model``: its train state and step."""
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    opt = build_optimizer("adamw", lr, model, clip_norm=1.0)
    return (create_train_state(model, opt, seed=11),
            make_task_train_step(model, opt, task_cfg, task))


def compare_steps(task_cfg, batch_np, flagged, hm, fuse, pmask, masks_ln):
    """Phase 13: one fp32 step with the kernels and with the twins, without
    and with the LayerNorm flags (``flagged``), with the head-major
    attention (``hm``), whose step is also held to the same step on the
    natural layout, and with the hidden-mask flags (``fuse``, ``pmask``,
    and both with the LayerNorm flags: ``masks_ln``), whose steps are also
    held to the same weights with those flags off: the same seed draws the
    same masks."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    batch = to_device({k: v[:64] for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    cases = (
        ("dropout", CONFIG, expect(attention_dropout_fwd=12,
                                   attention_dropout_bwd=12,
                                   **k10(K10_SITES))),
        ("dropout-free", CONFIG, expect(attention_fwd=12, attention_bwd=12)),
        ("LN flags, dropout", flagged, expect(
            attention_dropout_fwd=12, attention_dropout_bwd=12,
            layer_norm_fwd=5, layer_norm_bwd=5, dropout_residual_ln_fwd=24,
            dropout_residual_ln_bwd=24, **k10(K10_FLAGGED))),
        ("LN flags, dropout-free", flagged, expect(
            attention_fwd=12, attention_bwd=12, layer_norm_fwd=29,
            layer_norm_bwd=29)),
        ("head-major, dropout", hm, expect(
            attention_dropout_head_major_fwd=12,
            attention_dropout_head_major_bwd=12, **k10(K10_SITES))),
        ("head-major, dropout-free", hm, expect(
            attention_head_major_fwd=12, attention_head_major_bwd=12)),
        ("hidden masks (row 9), dropout", fuse, expect(
            attention_dropout_hidden_masks_fwd=12,
            attention_dropout_head_major_bwd=12, **k10(K10_FLAGGED))),
        ("keep-mask kernel (row 14), dropout", pmask, expect(
            attention_dropout_fwd=12, attention_dropout_bwd=12,
            keep_mask=24, **k10(K10_FLAGGED))),
        ("rows 9 and 14 with the LN flags, dropout", masks_ln, expect(
            attention_dropout_hidden_masks_fwd=12,
            attention_dropout_head_major_bwd=12, layer_norm_fwd=29,
            layer_norm_bwd=29, **k10(K10_FLAGGED))))
    for mode, config, want in cases:
        model = build_model(task_cfg, "float32", config)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        routes = {"kernel": contextlib.nullcontext, "twin": twins}
        if config == hm:
            routes["natural"] = lambda: natural_layout(model)
        if config in (fuse, pmask, masks_ln):
            routes["flags off"] = lambda: mask_flags_off(model)
        res = {}
        for route, ctx in routes.items():
            model.load_state_dict(init)
            model.train("dropout-free" not in mode)
            state, step = new_step(model, task_cfg, 1e-4)
            reset_launches()
            with ctx():
                loss = float(step(state, batch)["loss"])
            res[route] = (loss, {k: v.clone()
                                 for k, v in model.state_dict().items()},
                          dict(LAUNCHES))
        counts = res["kernel"][2]
        if counts != want:
            raise RuntimeError(f"{mode} kernel step launched {counts}, "
                               f"expected {want}")
        lk, pk, _ = res["kernel"]
        upd = max(float((pk[n] - init[n]).abs().max()) for n in pk)
        for other in list(routes)[1:]:
            lt, pt, _ = res[other]
            diff = max(float((pk[n] - pt[n]).abs().max()) for n in pk)
            exact = lk == lt and diff == 0.0
            print(f"fp32 step ({mode}), 64 rows, kernels vs {other}: loss "
                  f"{lk:.6f} vs {lt:.6f}, params max abs diff {diff:.3e} "
                  f"(largest update {upd:.3e}, tol {STEP_TOL:g} of it), "
                  f"{'bit-exact' if exact else 'not bit-exact'}, kernel "
                  f"launches {counts}", flush=True)
            if not (abs(lk - lt) <= 1e-5 * abs(lt)
                    and diff <= STEP_TOL * upd and np.isfinite(lk)):
                raise RuntimeError(f"{mode} step disagrees with the {other}")
        del model, init, res
        torch.cuda.empty_cache()


def grads(model, task_cfg, batch):
    """The loss and every parameter's gradient (float32) of one batch: the
    train step's forward, task loss and backward, without the optimizer."""
    from volta_tpu_torch.task_utils import process_batch, \
        task_loss_and_score

    tc = task_cfg["TASK1"]
    inputs, info = process_batch(tc, batch)
    pred = model(inputs["input_ids"], inputs["image_feat"],
                 inputs["image_loc"], "TASK1", inputs["token_type_ids"],
                 inputs["attention_mask"], inputs["image_attention_mask"],
                 dropout_seed=0)
    loss, _ = task_loss_and_score(tc["type"], pred, batch, info,
                                  tc.get("loss", "BCEWithLogitLoss"))
    loss.backward()
    out = {n: p.grad.float().clone() for n, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def grad_distance(a, b):
    """The distance of gradients a from b: the largest over parameters of
    ||a - b|| / ||b|| (L2 norms), and that parameter. The key projections'
    biases are left out: their gradient is 0 up to rounding (a constant
    added to every score of a row leaves its softmax unchanged), so their
    relative distance measures nothing but rounding."""
    return max((float((a[n] - b[n]).norm() / b[n].norm()), n) for n in b
               if not n.endswith("key.bias") and float(b[n].norm()) > 0)


def compare_bf16_grads(task_cfg, batch_np, hm, fuse):
    """Phase 13, bf16: the gradients of one b256 batch with the kernels
    against the twins, dropout-free (rows 1-2 natural, 7-8 head-major) and
    with the config's dropout (rows 3-4 natural, 5-6 head-major, and with
    ``fuse_hidden_dropout`` (``fuse``) rows 9 and 6; the twins draw the
    same hash masks): the backwards on the tensor-core bodies,
    within NOISE_FACTOR times the twins' distance from the twins with the
    attention's sums in float64 (forward and backward), at least GRAD_TOL;
    the dropout-free head-major model's distance from the natural
    layout's, with the kernels and with the twins."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.train_step import _widen_wire

    batch = to_device(_widen_wire({k: v for k, v in batch_np.items()
                                   if isinstance(v, np.ndarray)}), "cuda")
    for tag, config, dropout, want in (
            ("natural", CONFIG, False,
             expect(attention_fwd=12, attention_bwd=12)),
            ("head-major", hm, False,
             expect(attention_head_major_fwd=12,
                    attention_head_major_bwd=12)),
            ("natural", CONFIG, True,
             expect(attention_dropout_fwd=12, attention_dropout_bwd=12,
                    **k10(K10_SITES))),
            ("head-major", hm, True,
             expect(attention_dropout_head_major_fwd=12,
                    attention_dropout_head_major_bwd=12, **k10(K10_SITES))),
            ("fuse_hidden_dropout", fuse, True,
             expect(attention_dropout_hidden_masks_fwd=12,
                    attention_dropout_head_major_bwd=12,
                    **k10(K10_FLAGGED)))):
        what = "with dropout" if dropout else "dropout-free"
        model = build_model(task_cfg, "bfloat16", config).train(dropout)
        reset_launches()
        lk, gk = grads(model, task_cfg, batch)
        counts = dict(LAUNCHES)
        if counts != want:
            raise RuntimeError(f"bf16 {tag} gradients {what} launched "
                               f"{counts}, expected {want}")
        with twins():
            lt, gt = grads(model, task_cfg, batch)
        with twins(), float64_attention():
            l64, g64 = grads(model, task_cfg, batch)
        (noise, nworst), (diff, worst) = (grad_distance(g64, gt),
                                          grad_distance(gk, gt))
        tol = max(GRAD_TOL, NOISE_FACTOR * noise)
        print(f"bf16 gradients b{batch['question'].shape[0]} {what} "
              f"({tag}): kernels vs plain twins {diff:.3e} at {worst} (tol "
              f"{tol:.3e}; GRAD_TOL {GRAD_TOL:g}), twins vs float64 "
              f"attention sums {noise:.3e} at {nworst}; loss "
              f"{lk:.6f} / {lt:.6f} / {l64:.6f}; kernel launches {counts}",
              flush=True)
        if not (np.isfinite(lk) and all(bool(torch.isfinite(g).all())
                                        for g in gk.values())):
            raise RuntimeError(f"non-finite bf16 {tag} gradients {what}")
        if diff > tol:
            raise RuntimeError(f"bf16 {tag} gradients {what} disagree with "
                               "the plain twins")
        if tag == "head-major" and not dropout:
            with natural_layout(model):
                _, gn = grads(model, task_cfg, batch)
                with twins():
                    _, gtn = grads(model, task_cfg, batch)
            print(f"bf16 gradients dropout-free, head-major vs natural "
                  f"layout: kernels {grad_distance(gk, gn)}, twins "
                  f"{grad_distance(gt, gtn)}", flush=True)
        del model
        torch.cuda.empty_cache()


def step_rates(step, state, batch, routes, power, what):
    """pairs/s of the train step under two named routes in ab_turns, with
    the peak memory of each; returns {name: (median pairs/s, median
    ms/step)}."""
    import torch

    n = int(batch["question"].shape[0])
    (name_a, route_a), (name_b, route_b) = routes
    runs = {name_a: [], name_b: []}
    for name, route in ab_turns(name_a, route_a, name_b, route_b):
        with route():
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=2)
            runs[name].append((n / (ms / 1e3), ms,
                               torch.cuda.max_memory_allocated() / 2**30))
    out = {}
    for name, rs in runs.items():
        rate = float(np.median([r for r, _, _ in rs]))
        ms = float(np.median([m for _, m, _ in rs]))
        out[name] = (rate, ms)
        print(f"train step b{n} bf16 {what} {name}: median {rate:.1f} "
              f"pairs/s ({ms:.2f} ms/step; runs "
              f"{', '.join(f'{r:.1f}' for r, _, _ in rs)}), peak "
              f"{max(m for _, _, m in rs):.2f} GiB [{power}]", flush=True)
    return out


def train_throughput(task_cfg, batch_np, power, profile, flagged, hm,
                     hm_free, fuse, pmask):
    """Phase 14: pairs/s of the b256 bf16 train step with the kernels and
    with the twins (LayerNorm kernels off), then with the LayerNorm kernels
    on and off, then the head-major config (``hm``) against the same
    weights on the natural layout, then the dropout-free step (``hm_free``)
    head-major and natural, then each hidden-mask flag (``fuse``,
    ``pmask``) against the same weights with it off; peak memory; with
    ``profile`` the device time by kernel of the step without and with the
    LayerNorm kernels, head-major, dropout-free natural and head-major, and
    with each hidden-mask flag."""
    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import warmup_linear_schedule

    model = build_model(task_cfg, "bfloat16", flagged).train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    off = lambda: ln_kernels_off(model)
    with off():
        rates = step_rates(step, state, batch,
                           (("kernels", contextlib.nullcontext),
                            ("twins", twins)), power, "LN kernels off,")
    rates.update(step_rates(step, state, batch,
                            (("LN kernels on", contextlib.nullcontext),
                             ("LN kernels off", off)), power, "kernels,"))
    if profile:
        with off():
            profile_device(lambda: step(state, batch), rates["kernels"][1],
                           "LN kernels off")
        profile_device(lambda: step(state, batch),
                       rates["LN kernels on"][1], "LN kernels on")
    del model, state, step
    model = build_model(task_cfg, "bfloat16", hm).train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    rates.update(step_rates(step, state, batch,
                            (("head-major", contextlib.nullcontext),
                             ("natural", lambda: natural_layout(model))),
                            power, "kernels, LN kernels off,"))
    if profile:
        profile_device(lambda: step(state, batch), rates["head-major"][1],
                       "head-major")
    del model, state, step
    rates.update(dropout_free_rates(task_cfg, batch, power, profile,
                                    hm_free))
    for config, flag in ((fuse, "fuse_hidden_dropout"),
                         (pmask, "use_pallas_dropout_mask")):
        model = build_model(task_cfg, "bfloat16", config).train()
        state, step = new_step(model, task_cfg,
                               warmup_linear_schedule(1e-4, 10, 1000))
        rates.update(step_rates(step, state, batch,
                                ((flag, contextlib.nullcontext),
                                 (f"{flag} off",
                                  lambda: mask_flags_off(model))),
                                power, "kernels, LN kernels off,"))
        if profile:
            profile_device(lambda: step(state, batch), rates[flag][1], flag)
        del model, state, step
    return rates


def dropout_free_rates(task_cfg, batch, power, profile, hm_free):
    """The b256 bf16 train step with dropout 0 (``hm_free``: rows 7-8, and
    rows 1-2 on the same weights on the natural layout), head-major vs
    natural in turns; with ``profile`` the device time of each by kernel."""
    from volta_tpu_torch.optimization import warmup_linear_schedule

    model = build_model(task_cfg, "bfloat16", hm_free).train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    nat = lambda: natural_layout(model)  # noqa: E731
    rates = step_rates(step, state, batch,
                       (("head-major dropout-free", contextlib.nullcontext),
                        ("natural dropout-free", nat)),
                       power, "kernels, LN kernels off,")
    if profile:
        with nat():
            profile_device(lambda: step(state, batch),
                           rates["natural dropout-free"][1],
                           "natural dropout-free")
        profile_device(lambda: step(state, batch),
                       rates["head-major dropout-free"][1],
                       "head-major dropout-free")
    return rates


@contextlib.contextmanager
def remat_on(model):
    """The model's feed-forward sublayers recomputed in the backward, as
    ``remat_ff`` builds them; the same weights. Used where the config's
    ``remat_ff`` changes nothing else (no ``use_pallas_dropout_mask``)."""
    enc = model.bert.encoder
    saved, enc.remat = enc.remat, True
    try:
        yield
    finally:
        enc.remat = saved


@contextlib.contextmanager
def hash_tails(model):
    """The sublayer tails on the hash dropout, whatever
    ``use_hash_dropout`` built: the same weights."""
    from volta_tpu_torch.models.layers import LayerNorm

    lns = [m for m in model.modules() if isinstance(m, LayerNorm)]
    saved = [m.hash_mask for m in lns]
    for m in lns:
        m.hash_mask = True
    try:
        yield
    finally:
        for m, s in zip(lns, saved):
            m.hash_mask = s


def run_to_run(task_cfg, batch):
    """The parameters whose gradient differs between two runs of the same
    b256 step with torch's default algorithms, with their modules' types:
    the ops that sum in a run-dependent order (none since the token-type
    table sums its gradient in a fixed order)."""
    import torch

    runs = []
    for _ in range(2):
        model = build_model(task_cfg, "bfloat16").train()
        runs.append(grads(model, task_cfg, batch))
        kinds = {n: type(m).__name__ for n, m in model.named_modules()}
        del model
        torch.cuda.empty_cache()
    (la, ga), (lb, gb) = runs
    differ = [(n, kinds[n.rsplit(".", 1)[0]], f"{float((ga[n] - gb[n]).abs().max()):.3e}")
              for n in ga if not torch.equal(ga[n], gb[n])]
    print(f"two runs of one b256 bf16 step, default algorithms: loss "
          f"{la!r} vs {lb!r}, gradients that differ (name, module, max abs "
          f"diff): {differ}", flush=True)
    return differ


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def max_diff(a, b):
    """The largest absolute difference over the tensors of two name ->
    tensor dicts, and its name."""
    return max((float((a[n].float() - b[n].float()).abs().max()), n)
               for n in a)


def remat_steps(task_cfg, batch, plain, remat, counts, what):
    """Phase 15 (a): the same weights and seed through ``plain`` and its
    ``remat_ff`` copy: the loss and every gradient of one batch, then two
    train steps, bit-equal; ``counts`` the exact launches a step of each."""
    import torch

    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    res = {}
    for tag, config in (("plain", plain), ("remat_ff", remat)):
        model = build_model(task_cfg, "bfloat16", config).train()
        if model.bert.encoder.remat != (tag == "remat_ff"):
            raise RuntimeError(f"{config} built remat="
                               f"{model.bert.encoder.remat}")
        loss, g = grads(model, task_cfg, batch)
        state, step = new_step(model, task_cfg, 1e-4)
        reset_launches()
        losses = torch.stack([step(state, batch)["loss"] for _ in range(2)])
        launches = dict(LAUNCHES)
        want = expect(**{k: 2 * c for k, c in counts[tag].items()})
        if launches != want:
            raise RuntimeError(f"{what} {tag}: two steps launched {launches}, "
                               f"expected {want}")
        res[tag] = (loss, g, losses.cpu(), params_of(model))
        del model, state, step
        torch.cuda.empty_cache()
    (l0, g0, s0, p0), (l1, g1, s1, p1) = res["plain"], res["remat_ff"]
    gd, pd = max_diff(g0, g1), max_diff(p0, p1)
    print(f"remat_ff vs plain ({what}), b256 bf16, same weights and seed, "
          "default algorithms: "
          f"loss {l0!r} vs {l1!r}, gradients max abs diff {gd[0]:.3e} "
          f"({gd[1]}), two steps' losses {s0.tolist()} vs {s1.tolist()}, "
          f"params max abs diff {pd[0]:.3e}; launches a step "
          f"{counts['remat_ff']}", flush=True)
    if not (l0 == l1 and gd[0] == 0.0 and torch.equal(s0, s1)
            and pd[0] == 0.0 and np.isfinite(l0)):
        raise RuntimeError(f"remat_ff ({what}) is not bit-equal to the plain "
                           "step")


def int_threshold_steps(task_cfg, batch, int_thr, int_thr_ln, counts):
    """Phase 15 (b): ``use_hash_dropout: false``: each tail's keep
    fraction 0.9 +- 0.005, the same seed twice bit-equal, no K10 at the
    tails; with ``use_fused_residual_ln`` the tails take row 12;
    ``counts`` the configs' plan."""
    import torch

    from volta_tpu_torch.models import layers
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    fractions = []
    keep_fn = layers.int_threshold_keep

    def counted(bits, rate):
        keep = keep_fn(bits, rate)
        fractions.append(keep.float().mean())
        return keep

    layers.int_threshold_keep = counted
    try:
        model = build_model(task_cfg, "bfloat16", int_thr).train()
        runs = [grads(model, task_cfg, batch) for _ in range(2)]
        (la, ga), (lb, gb) = runs
        per_forward = len(fractions) // 2
        state, step = new_step(model, task_cfg, 1e-4)
        reset_launches()
        del fractions[:]
        loss = float(step(state, batch)["loss"])
        launches = dict(LAUNCHES)
        fr = torch.stack(fractions).cpu().tolist()
    finally:
        layers.int_threshold_keep = keep_fn
    attn, tails = counts["attn"], counts["tails"]
    want = expect(attention_dropout_fwd=attn, attention_dropout_bwd=attn,
                  **k10(K10_FLAGGED))
    print(f"int threshold (use_hash_dropout false), b256 bf16: {len(fr)} "
          f"tails a step, keep fractions {min(fr):.5f}-{max(fr):.5f}; the "
          f"same seed twice (default algorithms): loss {la!r} vs {lb!r}, "
          "gradients max abs diff "
          f"{max_diff(ga, gb)[0]:.3e}; step loss {loss:.4f}, launches "
          f"{launches}", flush=True)
    if per_forward != tails or len(fr) != tails or \
            not all(abs(f - 0.9) <= 0.005 for f in fr):
        raise RuntimeError(f"int threshold tails: {per_forward} a forward, "
                           f"keep fractions {fr}")
    if la != lb or max_diff(ga, gb)[0] != 0.0 or not np.isfinite(loss):
        raise RuntimeError("the int threshold step is not repeatable")
    if launches != want:
        raise RuntimeError(f"int threshold step launched {launches}, "
                           f"expected {want}")
    del model, state, step, runs
    model = build_model(task_cfg, "bfloat16", int_thr_ln).train()
    state, step = new_step(model, task_cfg, 1e-4)
    reset_launches()
    loss = float(step(state, batch)["loss"])
    want = expect(attention_dropout_fwd=attn, attention_dropout_bwd=attn,
                  dropout_residual_ln_fwd=tails, dropout_residual_ln_bwd=tails,
                  **k10(K10_FLAGGED))
    print(f"int threshold with use_fused_residual_ln: loss {loss:.4f}, "
          f"launches {dict(LAUNCHES)}", flush=True)
    if dict(LAUNCHES) != want or not np.isfinite(loss):
        raise RuntimeError(f"int threshold + fused residual launched "
                           f"{dict(LAUNCHES)}, expected {want}")
    del model, state, step
    torch.cuda.empty_cache()


def export_reload(root, data_dir, yml, config=CONFIG, tag="export"):
    """Phase 15 (c) and 18 (f): a model of ``config`` exported as a
    reference ``.bin`` and read by the eval CLI's loader into a model of
    other random weights: its b1024 logits bit-equal to the source's."""
    import torch

    from volta_tpu_torch import eval_task
    from volta_tpu_torch.checkpoint import save_reference_checkpoint
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device

    argv = ["--config_file", config, "--tasks_config_file", yml, "--task",
            "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, f"results_{tag}"),
            "--num_workers", "4", "--compute_dtype", "bfloat16",
            "--device", "cuda", "--seed", "0"]
    src, task_cfg, task, data = eval_task.setup(eval_task.parse_args(argv))
    path = os.path.join(root, "pytorch_model.bin")
    t0 = time.time()
    save_reference_checkpoint(path, src.cfg, src)
    saved = time.time() - t0
    t0 = time.time()
    loaded = eval_task.setup(eval_task.parse_args(
        argv + ["--seed", "7", "--from_pretrained", path]))[0]
    load_s = time.time() - t0
    batch = to_device(concat_batches(list(data["loader"])[:4]), "cuda")
    with torch.no_grad():
        a = make_task_eval_step(src, task_cfg, task)(batch)["prediction"]
        b = make_task_eval_step(loaded, task_cfg, task)(batch)["prediction"]
    print(f"{tag} -> {os.path.getsize(path) / 2**20:.1f} MiB .bin "
          f"({saved:.1f} s) -> eval_task loader ({load_s:.1f} s incl. data): "
          f"b{a.shape[0]} logits max abs diff "
          f"{float((a.float() - b.float()).abs().max()):.3e}", flush=True)
    if a.shape[0] != 1024 or not torch.equal(a, b):
        raise RuntimeError("the exported .bin does not reload bit-equal")
    os.unlink(path)


def resume_runs(root, task_cfg, batch, config, k=2):
    """Phase 15 (c): 2k steps uninterrupted, twice, against k steps, the
    port's train state saved, fresh objects, restored and k more; and a
    reference tar of the same state resumed the same way (the generator,
    which the tar does not hold, given alike), with torch's default
    algorithms: parameters, moments, losses, counts and generator
    bit-equal, or, where the two uninterrupted runs differ, no further
    apart than they are."""
    import torch

    from volta_tpu_torch import checkpoint as ck

    def snapshot(state, losses):
        opt = state.optimizer.state_dict()
        return {"losses": torch.stack(losses).cpu(),
                "params": params_of(state.model),
                "mu": {n: t.clone() for n, t in opt["mu"].items()},
                "nu": {n: t.clone() for n, t in opt["nu"].items()},
                "counts": (state.step, opt["count"], opt["adam_count"]),
                "generator": state.generator.get_state()}

    def fresh(seed=0):
        model = build_model(task_cfg, "bfloat16", config, seed=seed).train()
        return new_step(model, task_cfg, 1e-4)

    def run(state, step, n):
        return [step(state, batch)["loss"] for _ in range(n)]

    whole = []
    for _ in range(2):
        state, step = fresh()
        whole.append(snapshot(state, run(state, step, 2 * k)))
        del state, step
    state, step = fresh()
    first = run(state, step, k)
    t0 = time.time()
    ck.save_train_state(os.path.join(root, "resume"), state, 0, 0.0)
    native_s = time.time() - t0
    t0 = time.time()
    ck.save_reference_tar(os.path.join(root, "latest.tar"),
                          state.model.cfg, state, epoch_id=0)
    tar_s = time.time() - t0
    gen = state.generator.get_state()
    del state, step
    torch.cuda.empty_cache()
    resumed = {}
    state, step = fresh(seed=5)  # other weights, another generator
    state.generator.manual_seed(99)
    ck.restore_train_state(os.path.join(root, "resume"), state)
    resumed["native"] = snapshot(state, first + run(state, step, k))
    del state, step
    state, step = fresh(seed=5)
    ck.resume_from_reference_tar(state.model.cfg, state,
                                 os.path.join(root, "latest.tar"))
    state.generator.set_state(gen)
    resumed["reference tar"] = snapshot(state,
                                        first + run(state, step, k))
    del state, step
    torch.cuda.empty_cache()

    def diff(a, b):
        d = max(max_diff(a[key], b[key])[0] for key in ("params", "mu", "nu"))
        return max(d, float((a["losses"] - b["losses"]).abs().max()))

    def same_meta(a, b):
        return a["counts"] == b["counts"] and torch.equal(a["generator"],
                                                          b["generator"])

    noise = diff(whole[0], whole[1])
    sizes = {what: os.path.getsize(os.path.join(root, f)) / 2**30
             for what, f in (("train state", "resume/train_state.pt"),
                             ("reference tar", "latest.tar"))}
    print(f"resume after {k} of {2 * k} steps, b256 bf16 with dropout, "
          f"default algorithms: train state {sizes['train state']:.2f} "
          f"GiB written in {native_s:.1f} s, reference tar "
          f"{sizes['reference tar']:.2f} GiB in {tar_s:.1f} s; two "
          f"uninterrupted runs differ by {noise:.3e}", flush=True)
    for what, snap in resumed.items():
        d = diff(snap, whole[0])
        print(f"  {what} resume vs uninterrupted: max abs diff {d:.3e}, "
              f"losses {snap['losses'].tolist()} vs "
              f"{whole[0]['losses'].tolist()}, counts {snap['counts']}, "
              "generator "
              f"{'equal' if same_meta(snap, whole[0]) else 'differs'}",
              flush=True)
        if not same_meta(snap, whole[0]) or d > noise:
            raise RuntimeError(f"the {what} resume differs from the "
                               "uninterrupted run")
    if not all(same_meta(w, whole[0]) for w in whole):
        raise RuntimeError("two uninterrupted runs end at other counts")
    os.unlink(os.path.join(root, "latest.tar"))


def check_remat_int_checkpoints(root, data_dir, yml, task_cfg, batch_np,
                                power, profile, flagged, pmask):
    """Phase 15: ``remat_ff``, ``use_hash_dropout: false`` and the
    checkpoint slice at full width, 4 layers (``uniter_cut``; b256,
    bf16), each run's launches from its config's plan."""
    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import warmup_linear_schedule

    base, counts = uniter_cut(root)
    flagged, pmask = uniter_cut(root, flagged)[0], uniter_cut(root, pmask)[0]
    remat = write_config(root, "ctrl_uniter_base_remat.json", base=base,
                         remat_ff=True)
    remat_ln = write_config(root, "ctrl_uniter_base_remat_ln_kernels.json",
                            base=base, remat_ff=True,
                            use_pallas_layernorm=True,
                            use_fused_residual_ln=True)
    remat_pmask = write_config(root, "ctrl_uniter_base_remat_keep_mask.json",
                               base=base, remat_ff=True,
                               use_pallas_dropout_mask=True)
    int_thr = write_config(root, "ctrl_uniter_base_int_threshold.json",
                           base=base, use_hash_dropout=False)
    int_thr_ln = write_config(
        root, "ctrl_uniter_base_int_threshold_fused_residual.json",
        base=base, use_hash_dropout=False, use_fused_residual_ln=True)
    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    tails, ff, sites = counts["tails"], counts["ff_tails"], counts["k10"]
    attn = dict(attention_dropout_fwd=counts["attn"],
                attention_dropout_bwd=counts["attn"])
    ln = dict(layer_norm_fwd=5, layer_norm_bwd=5,
              dropout_residual_ln_bwd=tails)
    # the recomputation replays each feed-forward tail's forward: K10, or
    # row 12 with the LayerNorm flags, one more launch a layer a step
    remat_steps(task_cfg, batch, base, remat, {
        "plain": dict(attn, **k10(sites)),
        "remat_ff": dict(attn, hash_dropout_fwd=sites + ff,
                         hash_dropout_bwd=sites)}, "default")
    remat_steps(task_cfg, batch, flagged, remat_ln, {
        "plain": dict(attn, dropout_residual_ln_fwd=tails, **ln,
                      **k10(K10_FLAGGED)),
        "remat_ff": dict(attn, dropout_residual_ln_fwd=tails + ff, **ln,
                         **k10(K10_FLAGGED))}, "LN flags")
    # row 14 is gated off by remat_ff: its tails take K10, which draws the
    # mask row 14 draws for the same seed
    remat_steps(task_cfg, batch, pmask, remat_pmask, {
        "plain": dict(attn, keep_mask=tails, **k10(K10_FLAGGED)),
        "remat_ff": dict(attn, hash_dropout_fwd=sites + ff,
                         hash_dropout_bwd=sites)},
        "use_pallas_dropout_mask")
    int_threshold_steps(task_cfg, batch, int_thr, int_thr_ln, counts)

    rates = {}
    for config, what, on, off in (
            (base, "default,", "remat_ff", "plain"),
            (flagged, "LN flags,", "remat_ff LN flags", "plain LN flags")):
        model = build_model(task_cfg, "bfloat16", config).train()
        state, step = new_step(model, task_cfg,
                               warmup_linear_schedule(1e-4, 10, 1000))
        rates.update(step_rates(step, state, batch,
                                ((on, lambda: remat_on(model)),
                                 (off, contextlib.nullcontext)),
                                power, what))
        if profile:
            with remat_on(model):
                profile_device(lambda: step(state, batch), rates[on][1], on)
            profile_device(lambda: step(state, batch), rates[off][1], off)
        del model, state, step
    model = build_model(task_cfg, "bfloat16", int_thr).train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    rates.update(step_rates(step, state, batch,
                            (("int threshold", contextlib.nullcontext),
                             ("hash tails", lambda: hash_tails(model))),
                            power, "default,"))
    if profile:
        profile_device(lambda: step(state, batch), rates["int threshold"][1],
                       "int threshold")
        with hash_tails(model):
            profile_device(lambda: step(state, batch),
                           rates["hash tails"][1], "hash tails")
    del model, state, step
    export_reload(root, data_dir, yml, base)
    resume_runs(root, task_cfg, batch, base)
    return rates


@contextlib.contextmanager
def plain_route(model):
    """The model's attention on the plain route (``use_pallas`` false at
    every attention sublayer), the same weights."""
    from volta_tpu_torch.models.encoder import GatedAttentionSublayer

    subs = [m for m in model.modules()
            if isinstance(m, GatedAttentionSublayer)]
    saved = [(m.use_pallas, m.fuse_hidden) for m in subs]
    for m in subs:
        m.use_pallas = m.fuse_hidden = False
    try:
        yield
    finally:
        for m, (up, fh) in zip(subs, saved):
            m.use_pallas, m.fuse_hidden = up, fh


def hold_to_twins(tag, logits, fn, batch, strict=False):
    """``logits`` (of the same weights on another route) against the twins'
    of ``fn`` on ``batch``, by phase 9's rule: within NOISE_FACTOR times
    (at least LOGIT_TOL) the twins' distance from the twins with float64
    attention sums, and no more than AGREE_SLACK more answers flipped,
    against the twins' answers and against the kernels'. ``strict``: no
    more answers flipped against the kernels' than the twins flip against
    float64 sums, without the slack."""
    import torch

    with twins():
        plain = fn(batch)["prediction"].float()
        with float64_attention():
            alt = fn(batch)["prediction"].float()
    kernels = fn(batch)["prediction"].float()
    noise = float((plain - alt).abs().max())
    agree_noise = float((alt.argmax(1) == plain.argmax(1)).float().mean())
    diff = float((logits - plain).abs().max())
    agree = float((logits.argmax(1) == plain.argmax(1)).float().mean())
    agree_k = float((logits.argmax(1) == kernels.argmax(1)).float().mean())
    tol = max(LOGIT_TOL, NOISE_FACTOR * noise)
    n = logits.shape[0]
    min_agree = agree_noise - AGREE_SLACK / n
    flips_k = int((logits.argmax(1) != kernels.argmax(1)).sum())
    flips_noise = int((alt.argmax(1) != plain.argmax(1)).sum())
    print(f"logits b{n} ({tag}) vs the kernels' twins: max abs "
          f"diff {diff:.3e} (tol {tol:.3e}; twins vs float64 sums "
          f"{noise:.3e}), answers agree {agree:.4f}, with the kernels' "
          f"{agree_k:.4f} (min {min_agree:.4f}; twins vs float64 sums "
          f"{agree_noise:.4f}); answers flipped against the kernels' "
          f"{flips_k} of {n}, the twins against float64 sums {flips_noise}"
          f"{' (strict: at most that)' if strict else ''}", flush=True)
    if not bool(torch.isfinite(logits).all()) or diff > tol \
            or min(agree, agree_k) < min_agree \
            or (strict and flips_k > flips_noise):
        raise RuntimeError(f"{tag} logits disagree with the twins")


def capture_eval(root, data_dir, yml, power):
    """Phase 17 (a): the eval CLI on VQA at b64 with ``--dump_attn 2``: the
    npz keys and shapes, each probability row (intra ‖ inter) summing to 1
    within 1e-3, the maps equal to a float64 softmax of the captured
    queries and keys with the batch's padding bias (within 1e-4), no
    attention kernel launched by the capture forwards (row 1 twelve times
    a batch, as without the dump), and the capture route's answers held
    to the kernel route's twins."""
    import torch

    from volta_tpu_torch import eval_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.ops.attention import additive_mask

    # the yml's eval batch is 256; --batch_size applies where it has none
    yml64 = os.path.join(root, "tasks_b64.yml")
    with open(yml) as f, open(yml64, "w") as g:
        g.write("".join(l for l in f if "eval_batch_size" not in l))
    out_dir = os.path.join(root, "results_capture")
    argv = ["--config_file", CONFIG, "--tasks_config_file", yml64,
            "--task", "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", out_dir, "--num_workers", "4",
            "--compute_dtype", "bfloat16", "--device", "cuda", "--seed", "0",
            "--dump_attn", "2", "--batch_size", "64"]
    reset_launches()
    t0 = time.time()
    summary = eval_task.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    n_batches = -(-summary["n"] // 64)
    print(f"eval_task.main --dump_attn 2 --batch_size 64: {summary['n']} "
          f"questions in {n_batches} batches, {wall:.1f} s wall (set-up and "
          f"two npz dumps included) [{power}], launches {launches}",
          flush=True)
    if launches != expect(attention_fwd=12 * n_batches):
        raise RuntimeError(f"capture eval launched {launches}")

    args = eval_task.parse_args(argv)
    model, task_cfg, task, data = eval_task.setup(args)
    batches = [b for _, b in zip(range(2), data["loader"])]
    h, d = 12, 64
    for bi, batch in enumerate(batches):
        path = os.path.join(out_dir, f"attn_val_{bi}.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        lt, lv = batch["question"].shape[1], batch["features"].shape[1]
        b = batch["question"].shape[0]
        want = {"question_id": (b,), "row_qid_index": (b,)}
        for s in range(12):
            for stream, lq in (("t", lt), ("v", lv)):
                want[f"s{s:02d}_{stream}_queries"] = (b, h, lq, d)
                want[f"s{s:02d}_{stream}_keys"] = (b, h, lq, d)
                want[f"s{s:02d}_{stream}_intra_attn"] = \
                    (b, h, lq, lt if stream == "t" else lv)
                want[f"s{s:02d}_{stream}_inter_attn"] = \
                    (b, h, lq, lv if stream == "t" else lt)
        got = {k: v.shape for k, v in arrays.items()}
        if got != want:
            raise RuntimeError(f"{path}: arrays {got}, expected {want}")
        if not all(arrays[k].dtype == np.float32 for k in arrays
                   if k.startswith("s")):
            raise RuntimeError(f"{path}: maps not float32")
        bias = additive_mask(torch.from_numpy(np.concatenate(
            [batch["input_mask"], batch["image_mask"]], 1)), torch.float64)
        row_err = map_err = 0.0
        for s in range(12):
            keys = torch.from_numpy(np.concatenate(
                [arrays[f"s{s:02d}_t_keys"], arrays[f"s{s:02d}_v_keys"]],
                2)).double()
            for stream, intra_first in (("t", True), ("v", False)):
                a = f"s{s:02d}_{stream}_"
                intra, inter = arrays[a + "intra_attn"], \
                    arrays[a + "inter_attn"]
                probs = np.concatenate([intra, inter] if intra_first
                                       else [inter, intra], -1)
                row_err = max(row_err, float(np.abs(
                    probs.astype(np.float64).sum(-1) - 1.0).max()))
                q = torch.from_numpy(arrays[a + "queries"]).double()
                ref = torch.softmax(q @ keys.transpose(-1, -2) / 8.0 + bias,
                                    -1).numpy()
                map_err = max(map_err, float(np.abs(probs - ref).max()))
        print(f"  {path.rsplit('/', 1)[1]}: {len(arrays)} arrays; "
              f"probability rows sum to 1 within {row_err:.2e} (tol 1e-3); "
              f"maps vs a float64 softmax of the captured queries and keys "
              f"{map_err:.2e} (tol 1e-4)", flush=True)
        if row_err > 1e-3 or map_err > 1e-4:
            raise RuntimeError(f"{path}: maps off")
        if not np.array_equal(arrays["question_id"], batch["question_id"]):
            raise RuntimeError(f"{path}: question ids")

    step = make_task_eval_step(model, task_cfg, task)
    one = to_device(batches[0], "cuda")
    from volta_tpu_torch.task_utils import process_batch

    inputs, _ = process_batch(task_cfg[task], one)
    reset_launches()
    with torch.inference_mode():
        logits, extras = model(
            inputs["input_ids"], inputs["image_feat"], inputs["image_loc"],
            task, inputs["token_type_ids"], inputs["attention_mask"],
            inputs["image_attention_mask"], output_probs=True)
    if dict(LAUNCHES) != expect() or len(extras["probs"]) != 12:
        raise RuntimeError(f"the capture forward launched {dict(LAUNCHES)}")
    hold_to_twins("capture route, b64 bf16", logits.float(), step, one,
                  strict=True)
    del model


def no_pallas_runs(root, data_dir, yml, power, batch_np, profile):
    """Phase 17 (b): ``--no_pallas``: the eval CLI and one train epoch (4
    steps at b256) launch no attention kernel and K10 27 + 27 a step; the
    plain route's b256 logits held to the kernel route's twins; ms/step and
    peak memory of the plain and the kernel route in turns."""
    import torch

    from volta_tpu_torch import eval_task, train_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import warmup_linear_schedule
    from volta_tpu_torch.task_utils import load_task_config

    argv = ["--config_file", CONFIG, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, "results_no_pallas"),
            "--num_workers", "4", "--compute_dtype", "bfloat16",
            "--device", "cuda", "--seed", "0", "--no_pallas"]
    reset_launches()
    summary = eval_task.main(argv)
    if dict(LAUNCHES) != expect() or summary["nonfinite_batches"]:
        raise RuntimeError(f"--no_pallas eval launched {dict(LAUNCHES)}")
    plain_model = eval_task.setup(eval_task.parse_args(argv))[0]
    kernel_model, task_cfg, task, data = eval_task.setup(
        eval_task.parse_args(argv[:-1]))
    one = to_device(next(iter(data["loader"])), "cuda")
    plain = make_task_eval_step(plain_model, task_cfg, task)(one)
    hold_to_twins("--no_pallas eval, b256 bf16",
                  plain["prediction"].float(),
                  make_task_eval_step(kernel_model, task_cfg, task), one)
    del plain_model, kernel_model

    targv = train_argv(root, data_dir, yml, CONFIG, 1, "no_pallas") + \
        ["--no_pallas"]
    reset_launches()
    t0 = time.time()
    out = train_task.main(targv)
    torch.cuda.synchronize()
    steps, losses = out["steps"], out["train_losses"]
    print(f"train_task.main --no_pallas: {steps} steps at b256, "
          f"{time.time() - t0:.1f} s wall, losses "
          f"{[round(l, 4) for l in losses]}, launches {dict(LAUNCHES)}",
          flush=True)
    if dict(LAUNCHES) != expect(**k10(K10_SITES * steps)) or \
            not np.all(np.isfinite(losses)):
        raise RuntimeError(f"--no_pallas train launched {dict(LAUNCHES)}")

    task_cfg = load_task_config(yml)
    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    model = build_model(task_cfg, "bfloat16").train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    rates = step_rates(step, state, batch,
                       (("plain route", lambda: plain_route(model)),
                        ("kernel route", contextlib.nullcontext)),
                       power, "default,")
    if profile:
        with plain_route(model):
            profile_device(lambda: step(state, batch),
                           rates["plain route"][1], "plain route")
    del model, state, step
    torch.cuda.empty_cache()
    return rates


def accumulation_check(task_cfg, batch, free):
    """Phase 17 (c): K = 2 over the two b128 halves against K = 1 on the
    b256 batch, fp32, dropout 0, the same weights: after one update the
    parameters within 1e-5, one update and one schedule tick on both."""
    import torch

    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    out = []
    for k in (1, 2):
        # eval mode: no dropout at all (the pooled output's fixed 0.1
        # would draw other masks for the halves); the step still trains
        model = build_model(task_cfg, "float32", free).eval()
        opt = build_optimizer("adamw", 1e-4, model, clip_norm=1.0,
                              grad_accum_steps=k)
        state = create_train_state(model, opt, seed=11)
        step = make_task_train_step(model, opt, task_cfg, "TASK1")
        n = batch["question"].shape[0] // k
        for i in range(k):
            step(state, {key: v[i * n:(i + 1) * n] for key, v in
                         batch.items()})
        out.append((params_of(model), state.step, opt.count))
        del model, opt, state, step
        torch.cuda.empty_cache()
    (pa, sa, ca), (pb, sb, cb) = out
    d = max_diff(pa, pb)
    print(f"gradient accumulation, fp32 dropout 0: K=2 on two b128 halves vs "
          f"K=1 on b256: params max abs diff {d[0]:.3e} ({d[1]}; tol 1e-5); "
          f"micro-steps {sb} vs {sa}, updates {cb} vs {ca}", flush=True)
    if d[0] > 1e-5 or (ca, cb) != (1, 1) or (sa, sb) != (1, 2):
        raise RuntimeError("K=2 accumulation disagrees with the b256 step")


def store_steps(root, data_dir, yml, task_yml, power):
    """Phase 17 (d): the device store. A VQA b256 step from the store and
    from the dense batch, the same weights and seed: the loss and every
    parameter after it equal to the bit; the same for an NLVR2 step at its
    b64 (the [b, 2] rows); the stores' GiB."""
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.data.loader import _load_chunk
    from volta_tpu_torch.task_utils import load_dataset, load_task_config
    from volta_tpu_torch.train_step import make_task_train_step, \
        store_to_device

    for task, path, tag in (("1", yml, "VQA"), ("12", task_yml, "NLVR2")):
        task_cfg = load_task_config(path)
        key = "TASK" + task
        args = train_task.parse_args(train_argv(root, data_dir, path, CONFIG,
                                                1, "store", task))
        data = load_dataset(args, VoltaConfig.from_json_file(CONFIG),
                            task_cfg, task, split="train")
        ds = data["train_dataset"]
        task_cfg[key].setdefault("num_labels", getattr(ds, "num_labels", 2))
        idx = np.arange(data["batch_size"])
        dense = _load_chunk(ds, idx)
        ds.enable_device_store(feat_dtype="float32")
        stored = _load_chunk(ds, idx)
        store = store_to_device(ds.device_store_arrays(), "cuda",
                                torch.bfloat16)
        gib = sum(t.numel() * t.element_size()
                  for t in store.values()) / 2**30
        runs = []
        for use_store, b in ((False, dense), (True, stored)):
            model = build_model(task_cfg, "bfloat16", task=key).train()
            state, _ = new_step(model, task_cfg, 1e-4, task=key)
            step = make_task_train_step(model, state.optimizer, task_cfg,
                                        key, store=store if use_store
                                        else None)
            loss = step(state, b)["loss"]
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(3):
                step(state, b)
            torch.cuda.synchronize()
            ms = (time.time() - t0) / 3 * 1e3
            runs.append((loss.cpu(), params_of(model), ms))
            del model, state, step
            torch.cuda.empty_cache()
        (la, pa, ma), (lb, pb, mb) = runs
        d = max_diff(pa, pb)
        print(f"device store, {tag} b{len(idx)} bf16: store {gib:.3f} GiB on "
              f"the card; first step's loss {la.item()!r} (dense) vs "
              f"{lb.item()!r} (store), params after 4 steps max abs diff "
              f"{d[0]:.3e}; wall {ma:.2f} vs {mb:.2f} ms/step (dense batch "
              f"on the host vs rows from the store) [{power}]", flush=True)
        if not torch.equal(la, lb) or d[0] != 0.0:
            raise RuntimeError(f"the {tag} store step differs from the "
                               "dense step")
        del store


def freeze_check(root, task_cfg, batch):
    """Phase 17 (e): ``fixed_layers`` [embeddings, attn_0]: after one step
    at lr 1e-2, weight decay 0.1, each frozen parameter that decays stands
    at p (1 - lr wd) within float32 rounding, each that does not decay
    where it was, and the others moved."""
    import torch

    from volta_tpu_torch.optimization import build_optimizer, no_decay_mask
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step
    from volta_tpu_torch.train_utils import apply_freeze, freeze_mask

    fixed = ["embeddings", "attn_0"]
    config = write_config(root, "ctrl_uniter_base_frozen.json",
                          fixed_layers=fixed)
    model = build_model(task_cfg, "bfloat16", config).train()
    lr, wd = 1e-2, 0.1
    opt = apply_freeze(build_optimizer("adamw", lr, model, weight_decay=wd,
                                       clip_norm=1.0), model,
                       model.cfg.fixed_layers)
    before = params_of(model)
    state = create_train_state(model, opt, seed=11)
    make_task_train_step(model, opt, task_cfg, "TASK1")(state, batch)
    after = params_of(model)
    trains, decays = freeze_mask(model, fixed), no_decay_mask(model)
    worst = still = 0.0
    moved = 0
    for n, p in before.items():
        if trains[n]:
            moved += not torch.equal(after[n], p)
            continue
        if decays[n]:
            want = p.double() * (1 - lr * wd)
            worst = max(worst, float(((after[n].double() - want).abs()
                                      / want.abs().clamp_min(1e-30)).max()))
        else:
            still = max(still, float((after[n] - p).abs().max()))
    n_frozen = sum(not t for t in trains.values())
    print(f"fixed_layers {fixed}: {n_frozen} frozen parameters; decayed "
          f"ones at p (1 - lr wd) within {worst:.2e} relative (tol 1e-6), "
          f"undecayed ones moved {still:.1e} (tol 0); {moved} of "
          f"{len(trains) - n_frozen} trained parameters moved", flush=True)
    # a trained tensor stands still only where its whole gradient is 0
    if worst > 1e-6 or still != 0.0 or moved < 0.9 * (len(trains) -
                                                      n_frozen):
        raise RuntimeError("frozen parameters moved by more than their decay")
    del model, opt, state


def embed_clf_check(root, data_dir, yml, task_cfg):
    """Phase 17 (f): ``embed_clf`` on the VQA answer space (3129 answers)
    with the classifier as wide as the text (``clf_hidden_size`` 768):
    ``dense2`` equals a float64 mean of each answer's word-embedding rows,
    in sorted answer order, within 1e-6."""
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.task_utils import load_dataset
    from volta_tpu_torch.train_utils import init_classifier_from_answers

    config = write_config(root, "ctrl_uniter_base_clf768.json",
                          clf_hidden_size=768)
    args = train_task.parse_args(train_argv(root, data_dir, yml, config, 1,
                                            "embed_clf"))
    ds = load_dataset(args, VoltaConfig.from_json_file(config), task_cfg,
                      "1", split="train")["train_dataset"]
    model = build_model(task_cfg, "bfloat16", config)
    if not init_classifier_from_answers(model, "TASK1", ds):
        raise RuntimeError("embed_clf did not set dense2")
    table = model.bert.embeddings.word_embeddings.weight.detach().double()
    tok = ds._tokenizer
    means = []
    for answer, _ in sorted(ds.ans2label.items()):
        ids = tok.convert_tokens_to_ids(tok.tokenize(answer)) or \
            tok.convert_tokens_to_ids([tok.unk_token])
        means.append(table[ids].mean(0))
    want = torch.stack(means)
    got = model.clf_TASK1.dense2.weight.detach().double()
    err = float((got - want).abs().max())
    print(f"embed_clf: dense2 {tuple(got.shape)} vs the float64 answer "
          f"means: max abs diff {err:.2e} (tol 1e-6)", flush=True)
    if err > 1e-6:
        raise RuntimeError("embed_clf's dense2 is not the answer means")
    del model


def train_cli_extras(root, data_dir, yml, power):
    """Phase 17 (h): the train CLI's own wiring of accumulation, the store,
    freezing and ``embed_clf``: one VQA epoch (b256 updates of two b128
    micro-batches) through ``train_task.main`` with
    ``--gradient_accumulation_steps 2 --device_store``, a config with ``fixed_layers`` [embeddings] and
    ``clf_hidden_size`` 768, a task with ``embed_clf``. The default route's
    exact launches (K10 27 + 27 a micro-step), one update every two
    micro-steps, finite losses; ``embed_clf`` set ``dense2``; the store
    was built from the loader's dataset; in the saved state the frozen
    parameters without decay stand where they started and those with it
    at their decay alone."""
    import torch

    from volta_tpu_torch import train_step as ts
    from volta_tpu_torch import train_task, train_utils
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import no_decay_mask
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    fixed = ["embeddings"]
    config = write_config(root, "ctrl_uniter_base_cli_extras.json",
                          fixed_layers=fixed, clf_hidden_size=768)
    clf_yml = os.path.join(root, "tasks_embed_clf.yml")
    with open(yml) as f, open(clf_yml, "w") as g:
        g.write(f.read() + "  embed_clf: true\n")
    argv = train_argv(root, data_dir, clf_yml, config, 1, "cli_extras") + \
        ["--gradient_accumulation_steps", "2", "--device_store"]
    # the loader's batch is the task's over K, as in the JAX CLI
    data = load_dataset(train_task.parse_args(argv),
                        VoltaConfig.from_json_file(config),
                        load_task_config(clf_yml), "1")
    n_val, micro_batch = len(data["val_loader"]), data["batch_size"]
    del data

    seen = {}
    real = (train_utils.init_classifier_from_answers,
            train_utils.apply_freeze, ts.store_to_device)

    def embed_clf(model, task, ds):
        seen["embed_clf"] = real[0](model, task, ds)
        return seen["embed_clf"]

    def freeze(opt, model, fixed_layers):
        seen.update(opt=opt, before=params_of(model),
                    trains=train_utils.freeze_mask(model, fixed_layers),
                    decays=no_decay_mask(model))
        return real[1](opt, model, fixed_layers)

    def store(arrays, device, dtype):
        out = real[2](arrays, device, dtype)
        seen["store_gib"] = sum(t.numel() * t.element_size()
                                for t in out.values()) / 2**30
        return out

    (train_utils.init_classifier_from_answers, train_utils.apply_freeze,
     ts.store_to_device) = (embed_clf, freeze, store)
    try:
        reset_launches()
        t0 = time.time()
        summary = train_task.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        (train_utils.init_classifier_from_answers, train_utils.apply_freeze,
         ts.store_to_device) = real
    launches = dict(LAUNCHES)
    steps, losses = summary["steps"], summary["train_losses"]
    saved = torch.load(os.path.join(summary["run_dir"], "ckpt",
                                    "train_state.pt"),
                       map_location="cpu", weights_only=True)
    updates = saved["optimizer"]["count"]
    opt, before = seen["opt"], seen["before"]
    factor = 1.0
    worst = still = 0.0
    for i in range(updates):
        factor *= 1 - opt.lr(i) * opt.weight_decay
    for n, trains in seen["trains"].items():
        if trains:
            continue
        was, now = before[n].cpu().double(), saved["model"][n].double()
        if seen["decays"][n]:
            worst = max(worst, float(((now - was * factor).abs()
                                      / (was * factor).abs().clamp_min(
                                          1e-30)).max()))
        else:
            still = max(still, float((now - was).abs().max()))
    n_frozen = sum(not t for t in seen["trains"].values())
    print(f"train_task.main --gradient_accumulation_steps 2 --device_store, "
          f"fixed_layers {fixed}, embed_clf: {steps} micro-steps at "
          f"b{micro_batch}, "
          f"{updates} updates, {wall:.1f} s wall (data, store and model "
          f"set-up included), losses {[round(l, 4) for l in losses]}, store "
          f"{seen.get('store_gib', 0.0):.3f} GiB, embed_clf set "
          f"{seen.get('embed_clf')}; {n_frozen} frozen parameters: decayed "
          f"ones at their decay within {worst:.2e} relative (tol 1e-6), "
          f"undecayed ones moved {still:.1e} (tol 0); launches {launches} "
          f"[{power}]", flush=True)
    want = expect(attention_dropout_fwd=12 * steps,
                  attention_dropout_bwd=12 * steps,
                  attention_fwd=12 * n_val, **k10(K10_SITES * steps))
    if launches != want:
        raise RuntimeError(f"CLI extras launches {launches}, expected {want}")
    if steps < 2 or updates != steps // 2 or len(losses) != steps or \
            not np.all(np.isfinite(losses)):
        raise RuntimeError(f"{steps} micro-steps, {updates} updates, "
                           f"losses {losses}")
    if seen.get("embed_clf") is not True or "store_gib" not in seen:
        raise RuntimeError("embed_clf or the device store did not apply")
    if not n_frozen or worst > 1e-6 or still != 0.0:
        raise RuntimeError("frozen parameters moved by more than their decay")
    seen.clear()
    torch.cuda.empty_cache()


def check_capture_train_extras(root, data_dir, yml, task_yml, task_cfg,
                               batch_np, power, free, profile):
    """Phase 17: capture, the plain route and the rest of the train CLI at
    ctrl_uniter_base's full width (bf16, L 60)."""
    from volta_tpu_torch.eval_step import to_device

    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    capture_eval(root, data_dir, yml, power)
    rates = no_pallas_runs(root, data_dir, yml, power, batch_np, profile)
    accumulation_check(task_cfg, batch, free)
    store_steps(root, data_dir, yml, task_yml, power)
    freeze_check(root, task_cfg, batch)
    embed_clf_check(root, data_dir, yml, task_cfg)
    differ = run_to_run(task_cfg, batch)
    if differ:
        raise RuntimeError(f"two default b256 steps differ in {differ}")
    train_cli_extras(root, data_dir, yml, power)
    return rates


# ----------------------------------------------------------------- phase 18
# the families' configs with the yml whose TASK1 (VQA) fields phase 18 runs
# them under, on the synthetic VQA dataroot
FAMILY_RUNS = {
    "ctrl_vilbert_base": "ctrl_trainval_tasks.yml",
    "vilbert_base": "vilbert_trainval_tasks.yml",
    "ctrl_lxmert": "ctrl_trainval_tasks.yml",
    "lxmert": "lxmert_trainval_tasks.yml",
    "ctrl_visualbert_base": "ctrl_trainval_tasks.yml",
    "ctrl_vl-bert_base": "ctrl_trainval_tasks.yml",
    "vl-bert_base": "vl-bert_trainval_tasks.yml",
}
# the attention launches a forward and K10's a training forward of each
# config, counted by hand from its plan: a check of plan_counts' derivation.
# The ViLBERTs run 30 query streams and 60 tails, the LXMERTs 34 and 58;
# the single-stream families' K10 counts are the 24 tails, their
# embeddings' sites (VisualBERT one, VL-BERT's obj_downsample input and
# joint output two) and the pooled output
FAMILY_COUNTS = {"ctrl_vilbert_base": (30, 63), "vilbert_base": (30, 63),
                 "ctrl_lxmert": (34, 61), "lxmert": (34, 61),
                 "ctrl_visualbert_base": (12, 26),
                 "ctrl_vl-bert_base": (12, 27), "vl-bert_base": (12, 27)}
# vilbert_base's rows 1-4 alone: the eval batch (1024, row 1) and the train
# batch (256, rows 1-4) at the co-attention's and the vision stream's
# (Lq, Lk), 8 heads of 128
WIDE_ROWS = [(b, lq, lk, train) for b, train in ((1024, False), (256, True))
             for lq, lk in ((23, 37), (37, 23), (37, 37))]


def plan_counts(cfg):
    """Launches of one forward of ``cfg``'s model at its dropout rates,
    from its sublayer plan, and of its backward: ``attn`` the attention
    launches (on the fused single-stream loop one an attention sublayer,
    else one a query stream the sublayer has), ``tails`` the sublayer
    tails (one over the joined sequence on the fused loop, with a single
    LayerNorm or where ``fuse_dual_stream`` joins two streams, else one a
    stream), ``ff_tails`` the feed-forwards' share of them, ``k10`` K10's
    launches a training forward: the tails, the embeddings' dropout sites
    and the pooled (or region) output's. The ``*_bwd`` counts leave out
    what autograd does not run back through: where the head reads no
    region output (``fusion_method`` text or vl-bert_vqa), the vision
    stream after the last sublayer whose vision output a text query reads
    (LXMERT's last layer) feeds no loss."""
    plan = cfg.sublayer_plan()
    fused = all(s.has_text and s.has_vision and s.shared and s.single_ln
                and (s.kind == "ff" or (s.has_tt and s.has_tv and s.has_vt
                                        and s.has_vv)) for s in plan)
    out = dict.fromkeys(("attn", "tails", "ff_tails", "attn_bwd",
                         "tails_bwd", "ff_tails_bwd"), 0)
    live_t = True
    live_v = fused or cfg.fusion_method not in ("text", "vl-bert_vqa")
    for s in reversed(plan):
        two = s.has_text and s.has_vision
        joined = fused or s.single_ln or (cfg.fuse_dual_stream and two)
        streams = 1 if fused else s.has_text + s.has_vision
        tails = 1 if joined else streams
        live = (live_t and s.has_text) + (live_v and s.has_vision)
        tails_bwd = min(live, 1) if joined else live
        out["tails"] += tails
        out["tails_bwd"] += tails_bwd
        if s.kind == "attn":
            out["attn"] += streams
            out["attn_bwd"] += min(live, 1) if fused else live
            live_t, live_v = (live_t or (live_v and s.has_vt),
                              live_v or (live_t and s.has_tv))
        else:
            out["ff_tails"] += tails
            out["ff_tails_bwd"] += tails_bwd
    emb = {"visualbert": 1, "vl-bert": 1 + (
        cfg.v_attention_probs_dropout_prob > 0)}.get(cfg.image_embeddings, 2)
    out["k10"] = out["tails"] + emb + 1
    out["k10_bwd"] = out["tails_bwd"] + emb + 1
    return out


def k10_of(counts, steps):
    """K10's launches in ``steps`` training steps of a plan's ``counts``."""
    return {"hash_dropout_fwd": counts["k10"] * steps,
            "hash_dropout_bwd": counts["k10_bwd"] * steps}


def family_yml(root, data_dir, src):
    """TASK1 (VQA) of ``config_tasks/<src>`` on the synthetic dataroot, in
    ``root``: its sequence and region lengths, batch sizes, lr and, for
    VL-BERT, its ``fusion_method`` and ``embed_clf``."""
    import yaml

    with open(os.path.join(REPO, "config_tasks", src)) as f:
        tc = yaml.safe_load(f)["TASK1"]
    tc.update(dataroot=data_dir,
              features_h5path1=os.path.join(data_dir, "features.lmdb"))
    path = os.path.join(root, "family_" + src)
    with open(path, "w") as f:
        yaml.safe_dump({"TASK1": tc}, f)
    return path


def family_data(root, data_dir, yml, config, tag):
    """The family's VQA loaders (its config and the yml's task, the fusion
    override applied): one eval batch of the yml's eval size and one train
    batch, numpy."""
    from volta_tpu_torch import train_task
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    task_cfg = load_task_config(yml)
    tc = task_cfg["TASK1"]
    data = load_dataset(train_task.parse_args(train_argv(
        root, data_dir, yml, config, 1, tag)), task_config(config, tc),
        task_cfg, "1")
    per = tc.get("eval_batch_size", tc["batch_size"]) // tc["batch_size"]
    arrays = lambda b: {k: v for k, v in b.items()  # noqa: E731
                        if isinstance(v, np.ndarray)}
    eval_np = concat_batches([arrays(b) for _, b in zip(
        range(per), data["val_loader"])])
    return task_cfg, eval_np, arrays(next(iter(data["train_loader"])))


def family_steps(task_cfg, eval_np, train_np, tag, config, steps=2):
    """Phase 18 (b)-(d): one eval batch of ``config`` held to the twins
    (``hold_task_logits``) and through the kernels with exact launches,
    then ``steps`` train steps with the config's dropout, exact launches,
    finite losses. Returns the launches of both runs and ms/step."""
    import torch

    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    counts = plan_counts(task_config(config, task_cfg["TASK1"]))
    model = hold_task_logits(task_cfg, "TASK1", eval_np, tag, config)
    batch = to_device(eval_np, "cuda")
    reset_launches()
    logits = make_task_eval_step(model, task_cfg, "TASK1")(batch)[
        "prediction"]
    torch.cuda.synchronize()
    launches = {"eval": dict(LAUNCHES)}
    want = expect(attention_fwd=counts["attn"])
    if launches["eval"] != want or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{tag} eval b{logits.shape[0]} launches "
                           f"{launches['eval']}, expected {want}")
    model.train()
    state, step = new_step(model, task_cfg, 1e-4)
    tbatch = to_device(train_np, "cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    losses = [float(step(state, tbatch)["loss"]) for _ in range(steps)]
    ms = (time.time() - t0) / steps * 1e3
    launches["train"] = dict(LAUNCHES)
    want = expect(attention_dropout_fwd=counts["attn"] * steps,
                  attention_dropout_bwd=counts["attn_bwd"] * steps,
                  **k10_of(counts, steps))
    print(f"{tag}: eval b{logits.shape[0]} launches {launches['eval']}; "
          f"{steps} train steps at b{train_np['question'].shape[0]}, "
          f"losses {losses}, {ms:.1f} ms/step on the host clock (the first "
          f"step's set-up included), launches {launches['train']}",
          flush=True)
    if launches["train"] != want or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"{tag} train launches {launches['train']}, "
                           f"expected {want}")
    del model, state, step
    torch.cuda.empty_cache()
    return launches


def check_family_rows():
    """Phase 18 (b): rows 1-4 alone at vilbert_base's shapes (WIDE_ROWS,
    H = 8, D = 128) against their twins, bf16 and fp32, as phase 16 holds
    the task shapes (their times, untimed since phase 22: PERF.md, PR
    17)."""
    import torch

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

    h, d = 8, 128
    scale = d ** -0.5
    for i, (b, lq, lk, train) in enumerate(WIDE_ROWS):
        for dt in ("bfloat16", "float32"):
            seed = 1800 + i
            q, k, v, bias = attention_inputs(b, lq, lk, h, d,
                                             getattr(torch, dt), seed)
            g = torch.randn_like(q)
            out1 = ac.attention_fwd(q, k, v, bias, scale, h)
            torch.cuda.synchronize()
            ref1 = ac.attention_fwd_ref(q, k, v, bias, scale, h)
            err1 = float((out1.float() - ref1.float()).abs().max())
            if not bool(torch.isfinite(out1).all()) or err1 > TOL[dt]:
                raise RuntimeError(f"row 1 disagrees at B={b} Lq={lq} "
                                   f"Lk={lk} D={d} {dt}: {err1:.3e}")
            line = f"row 1 {err1:.3e}"
            if train:
                got2 = ac.attention_bwd(q, k, v, bias, g, scale, h)
                out3, mask = adc.attention_dropout_fwd(
                    q, k, v, bias, scale, h, RATE, seed, return_mask=True)
                got4 = adc.attention_dropout_bwd(q, k, v, bias, g, scale, h,
                                                 RATE, seed)
                torch.cuda.synchronize()
                keep = adc.keep_mask(seed, (b, h, lq, lk), RATE,
                                     device="cuda")
                if not torch.equal(mask, keep):
                    raise RuntimeError(f"row-3 mask differs from the twin's "
                                       f"at B={b} Lq={lq} Lk={lk} {dt}")
                where = f"at B={b} Lq={lq} Lk={lk}"
                err2 = max(close(a, r, dt, f"row 2 d{n} {where}")
                           for n, a, r in zip("qkv", got2,
                                              ac.attention_bwd_ref(
                                                  q, k, v, bias, g, scale, h,
                                                  want_db=False)))
                ref3 = adc.attention_dropout_fwd_ref(q, k, v, bias, scale, h,
                                                     RATE, keep)
                err3 = float((out3.float() - ref3.float()).abs().max())
                if not bool(torch.isfinite(out3).all()) or err3 > TOL[dt]:
                    raise RuntimeError(f"row 3 disagrees {where} {dt}: "
                                       f"{err3:.3e}")
                err4 = max(close(a, r, dt, f"row 4 d{n} {where}")
                           for n, a, r in zip(
                               "qkv", got4, adc.attention_dropout_bwd_ref(
                                   q, k, v, bias, g, scale, h, RATE, keep)))
                line += (f", row 2 {err2:.3e}, row 3 {err3:.3e} (mask "
                         f"bit-equal, keep fraction "
                         f"{float(mask.float().mean()):.5f}), row 4 "
                         f"{err4:.3e}")
                del got2, out3, mask, got4, keep, ref3
            print(f"B={b} Lq={lq} Lk={lk} H={h} D={d} {dt} max abs diff vs "
                  f"twins: {line}", flush=True)
            del q, k, v, bias, g, out1, ref1


def family_flags(root, task_cfg, eval_np, train_np, base, steps=2):
    """Phase 18 (e): ctrl_vilbert_base's flags (``base`` its config file),
    two b256 train steps each
    with exact launches: the LayerNorm kernels (rows 10-13 at every
    per-stream tail), the head-major attention (rows 5-6, its eval logits
    equal to the natural layout's to the bit), the keep-mask kernel (row
    14), ``remat_ff`` (bit-equal to the plain step, ``remat_steps``) and
    ``fuse_dual_stream`` (one K10 a joined tail). Returns the launches of
    each."""
    import torch

    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.models.layers import LayerNorm
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    cfg = task_config(base, task_cfg["TASK1"])
    c = plan_counts(cfg)
    attn, tails = c["attn"], c["tails"]
    rows34 = dict(attention_dropout_fwd=attn, attention_dropout_bwd=c[
        "attn_bwd"])
    # K10 at the embeddings' and the pooled output's sites alone
    side = k10(c["k10"] - tails)
    tbatch = to_device(train_np, "cuda")
    out = {}
    flags = {
        "LayerNorm kernels": (dict(use_pallas_layernorm=True,
                                   use_fused_residual_ln=True), None),
        "head-major": (dict(attn_natural_layout=False), dict(
            attention_dropout_head_major_fwd=attn,
            attention_dropout_head_major_bwd=c["attn_bwd"],
            **k10_of(c, 1))),
        "keep-mask kernel": (dict(use_pallas_dropout_mask=True), dict(
            rows34, keep_mask=tails, **side)),
        "fuse_dual_stream": (dict(fuse_dual_stream=True), None),
    }
    for name, (fields, per_step) in flags.items():
        config = write_config(root, f"ctrl_vilbert_base_{len(out)}.json",
                              base=base, **fields)
        model = build_model(task_cfg, "bfloat16", config).train()
        if name == "LayerNorm kernels":
            # the LayerNorms outside the tails (the embeddings', the
            # classifier's) on rows 10-11, every tail on rows 12-13
            plain_lns = sum(isinstance(m, LayerNorm) and not n.endswith(
                "out_ln") for n, m in model.named_modules())
            per_step = dict(rows34, layer_norm_fwd=plain_lns,
                            layer_norm_bwd=plain_lns,
                            dropout_residual_ln_fwd=tails,
                            dropout_residual_ln_bwd=c["tails_bwd"], **side)
        if name == "fuse_dual_stream":
            fc = plan_counts(task_config(config, task_cfg["TASK1"]))
            if fc["tails"] >= tails:
                raise RuntimeError(f"fuse_dual_stream joins no tail: {fc}")
            per_step = dict(rows34, **k10_of(fc, 1))
        state, step = new_step(model, task_cfg, 1e-4)
        reset_launches()
        losses = [float(step(state, tbatch)["loss"]) for _ in range(steps)]
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        want = expect(**{k: n * steps for k, n in per_step.items()})
        print(f"ctrl_vilbert_base {name}: {steps} b256 steps, losses "
              f"{losses}, launches {launches}", flush=True)
        if launches != want or not np.all(np.isfinite(losses)):
            raise RuntimeError(f"{name}: launches {launches}, expected "
                               f"{want}")
        if name == "head-major":
            # as phase 11 holds the head-major model: its logits on the
            # natural layout, the same weights, equal to the bit
            model.eval()
            fn = make_task_eval_step(model, task_cfg, "TASK1")
            one = to_device({k: v[:256] for k, v in eval_np.items()}, "cuda")
            hm = fn(one)["prediction"]
            with natural_layout(model):
                nat = fn(one)["prediction"]
            print(f"ctrl_vilbert_base head-major vs natural layout, eval "
                  f"b256 bf16: max abs diff "
                  f"{float((hm.float() - nat.float()).abs().max()):.3e} "
                  "(tol 0)", flush=True)
            if not torch.equal(hm, nat):
                raise RuntimeError("the head-major dual-stream model "
                                   "disagrees with the natural layout")
        out[name] = launches
        del model, state, step
        torch.cuda.empty_cache()
    remat = write_config(root, "ctrl_vilbert_base_remat.json", base=base,
                         remat_ff=True)
    plain = dict(rows34, **k10_of(c, 1))
    # the backward's recomputation replays each feed-forward tail's K10
    # forward
    counts = {"plain": plain, "remat_ff": dict(
        plain, hash_dropout_fwd=c["k10"] + c["ff_tails_bwd"])}
    remat_steps(task_cfg, tbatch, base, remat, counts, "ctrl_vilbert_base")
    out["remat_ff"] = expect(**{k: 2 * n for k, n in
                                counts["remat_ff"].items()})
    return out


def check_families(root, data_dir, power):
    """Phase 18: the other families at full width on synthetic VQA, each
    config's launches counted from its plan and held to FAMILY_COUNTS.
    Returns the launches of every run and (a)'s rates."""
    from volta_tpu_torch.config import VoltaConfig

    for name, (attn, sites) in FAMILY_COUNTS.items():
        cfg = VoltaConfig.from_json_file(os.path.join(REPO, "configs",
                                                      name + ".json"))
        if FAMILY_RUNS[name] == "vl-bert_trainval_tasks.yml":
            cfg.fusion_method = "vl-bert_vqa"
        got = plan_counts(cfg)
        if (got["attn"], got["k10"]) != (attn, sites):
            raise RuntimeError(f"{name}: the plan gives {got}, expected "
                               f"{attn} attention and {sites} K10 launches")
    ymls = {src: family_yml(root, data_dir, src)
            for src in set(FAMILY_RUNS.values())}
    # every run at 4 layers a stream, ViLBERT's text stream 5 (the counts
    # above are the full configs')
    cuts = {name: cut_config(root, name, keep)
            for name, keep in FAMILY_CUTS.items()}
    config = cuts.__getitem__
    launches = {}
    # (a) ctrl_vilbert_base through both CLIs
    run = run_task(root, data_dir, ymls[FAMILY_RUNS["ctrl_vilbert_base"]],
                   power, "1", "ctrl_vilbert_base", True,
                   config=config("ctrl_vilbert_base"))
    launches["ctrl_vilbert_base"] = {k: run[k] for k in ("eval", "train")}
    # (b)-(d) one eval batch and two train steps of every other family
    for name in ("vilbert_base", "ctrl_lxmert", "lxmert",
                 "ctrl_visualbert_base", "ctrl_vl-bert_base",
                 "vl-bert_base"):
        yml = ymls[FAMILY_RUNS[name]]
        task_cfg, eval_np, train_np = family_data(root, data_dir, yml,
                                                  config(name), name)
        launches[name] = family_steps(task_cfg, eval_np, train_np, name,
                                      config(name))
        if name == "vilbert_base":
            check_family_rows()
    # (e) the flags, (f) the round trip, on ctrl_vilbert_base
    yml = ymls[FAMILY_RUNS["ctrl_vilbert_base"]]
    task_cfg, eval_np, train_np = family_data(
        root, data_dir, yml, config("ctrl_vilbert_base"), "flags")
    launches["ctrl_vilbert_base flags"] = family_flags(
        root, task_cfg, eval_np, train_np, config("ctrl_vilbert_base"))
    export_reload(root, data_dir, yml, config("ctrl_vilbert_base"),
                  "ctrl_vilbert_base export")
    return launches, run["rates"]


# ----------------------------------------------------------------- phase 19
# Conceptual Captions at examples/ctrl_uniter/concap/train.sh's width: b256,
# 38 tokens, 36 regions (+ the global row), 2048-d features, 1601-way class
# probabilities; 1024 train and 256 valid images of 10-36 boxes
CC_IMAGES, CC_BOXES = (1024, 256), (10, 36)
CC_SEQ, CC_REGIONS, CC_BATCH = 38, 36, 256
# K8 at the b256 and b512 steps' queries (127 negatives of 2048-d rows),
# the dense twin, and the b256 one against the blockwise twin
K8_SHAPES = ((256, 36, None), (512, 36, None), (256, 36, 4096))
K8_DIM, K8_NEG = 2048, 128
# bf16 scores on the other bf16 neighbour than the float64 sums round to:
# the gather body (float64 sums itself), at most this share of all
K8_FLIPS = 1e-4
# the tensor-core body (float32 sums), at most this many times the more of
# the float32 twin's and torch's bf16 all-pairs product's (JAX's
# composition on the card, float32 sums on the tensor cores), each within
# one bf16 ulp of torch's product's or of the float64 sums' (``k8_flips``)
K8_FLIP_FACTOR = 2
# fp32 scores and gradients, and bf16 gradients, relative to the largest
K8_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# lxmert.json and vl-bert_base.json at 4 layers a stream: the sublayers
# kept (LXMERT's first two text-and-vision layers and first two cross
# blocks; VL-BERT's first four layers)
PRETRAIN_CUTS = {"lxmert": (0, 1, 2, 3, 18, 19, 20, 21, 22, 23),
                 "vl-bert_base": tuple(range(8))}
# phase 18's runs the same way: ViLBERT's last text-only layer (sublayers
# 10-11, no vision) and its first two co-attention blocks (each a
# co-attention and a self-attention layer a stream), 5 text and 4 vision
# layers
VILBERT_CUT = tuple(range(10, 20))
FAMILY_CUTS = {"ctrl_vilbert_base": VILBERT_CUT, "vilbert_base": VILBERT_CUT,
               "ctrl_lxmert": PRETRAIN_CUTS["lxmert"],
               "lxmert": PRETRAIN_CUTS["lxmert"],
               "ctrl_visualbert_base": PRETRAIN_CUTS["vl-bert_base"],
               "ctrl_vl-bert_base": PRETRAIN_CUTS["vl-bert_base"],
               "vl-bert_base": PRETRAIN_CUTS["vl-bert_base"]}

def write_synth_cc(out, n_train, n_valid, seed):
    """A synthetic Conceptual Captions dataroot in the reference's formats,
    through the port's LMDB writer and msgpack codec: tensorpack-style
    ``{training,validation}_feat_all.lmdb`` of the 13-field records (10-36
    boxes of 2048-d non-negative float32 features, 1601-way class and
    401-way attribute distributions, labels and confidences, boxes in a
    640 x 480 image, a caption of WORD_STEMS), ``caption_{train,valid}
    .json`` and the 30522-token vocab. Returns (features, annotations)."""
    from volta_tpu_torch.data import lmdbx, serialization

    rng = np.random.RandomState(seed)
    feats_dir, ann_dir = (os.path.join(out, d)
                          for d in ("imgfeats", "annotations"))
    os.makedirs(feats_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for split, n, lmdb_name in (("train", n_train, "training_feat_all"),
                                ("valid", n_valid, "validation_feat_all")):
        items, keys, captions = [], [], {}
        for i in range(n):
            nb = int(rng.randint(CC_BOXES[0], CC_BOXES[1] + 1))
            logits = rng.randn(nb, 1601).astype(np.float32) * 2
            cls = np.exp(logits - logits.max(1, keepdims=True))
            attr = rng.rand(nb, 401).astype(np.float32)
            words = [WORD_STEMS[int(j)] for j in
                     rng.randint(0, len(WORD_STEMS), rng.randint(6, 20))]
            caption = "a " + " ".join(words) + " ."
            rec = [np.abs(rng.randn(nb, 2048) * 0.5).astype(np.float32),
                   cls / cls.sum(1, keepdims=True),
                   rng.randint(0, 1600, nb).astype(np.int64),
                   rng.rand(nb).astype(np.float32),
                   rng.randint(0, 400, nb).astype(np.int64),
                   rng.rand(nb).astype(np.float32),
                   attr / attr.sum(1, keepdims=True), synth_boxes(rng, nb),
                   nb, 480, 640, i, caption]
            keys.append(serialization.tensorpack_key(i))
            items.append((keys[-1], serialization.dumps(rec)))
            captions[str(i)] = caption
        items.append((b"__keys__", serialization.dumps(keys)))
        lmdbx.write(os.path.join(feats_dir, lmdb_name + ".lmdb"), items)
        del items
        with open(os.path.join(ann_dir, f"caption_{split}.json"), "w") as f:
            json.dump(captions, f)
    write_synth_vocab(os.path.join(out, "vocab.txt"))
    return feats_dir, ann_dir


def concap_argv(root, cc_dir, epochs, config=CONFIG):
    """train.sh's flags (examples/ctrl_uniter/concap/train.sh) on the
    synthetic dataroot, for ``epochs`` epochs, on the card, bf16."""
    return ["--config_file", config,
            "--annotations_path", os.path.join(cc_dir, "annotations"),
            "--features_path", os.path.join(cc_dir, "imgfeats"),
            "--vocab_file", os.path.join(cc_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, "cc_save"),
            "--logdir", os.path.join(root, "cc_logs"),
            "--adam_epsilon", "1e-6", "--adam_betas", "0.9", "0.999",
            "--train_batch_size", str(CC_BATCH), "--max_seq_length",
            str(CC_SEQ), "--learning_rate", "1e-4", "--weight_decay", "0.01",
            "--warmup_proportion", "0.1", "--clip_grad_norm", "5.0",
            "--objective", "1", "--num_train_epochs", str(epochs),
            "--gradient_accumulation_steps", "1", "--in_memory", "True",
            "--num_workers", "4", "--seed", "0"]


def cut_config(root, name, keep, src=None):
    """configs/<name>.json (or the config at ``src``) with only the
    sublayers ``keep``, renumbered in order, written into ``root`` as
    <name>_cut.json; BERT layers whose sublayer is cut drop out of the
    layer maps."""
    with open(src or os.path.join(REPO, "configs", name + ".json")) as f:
        cfg = json.load(f)
    new = {old: i for i, old in enumerate(sorted(keep))}
    for key, val in list(cfg.items()):
        if key.endswith("_sublayers"):
            cfg[key] = [new[i] for i in val if i in new]
        elif key.startswith("bert_layer2"):
            cfg[key] = {k: new[v] for k, v in val.items() if v in new}
        elif key.startswith("sublayer2"):
            cfg[key] = {str(new[int(k)]): v for k, v in val.items()
                        if int(k) in new}
    path = os.path.join(root, f"{name}_cut.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def pretrain_counts(cfg):
    """``plan_counts`` of the pretraining model: the MLM head reads every
    text output and the region heads every region output, so both streams
    feed a loss whatever the fusion; the pooled output's K10 runs unless
    ``fusion_method`` is none (no pooled output)."""
    import dataclasses

    counts = plan_counts(dataclasses.replace(cfg, fusion_method="mul"))
    pooled = cfg.fusion_method != "none"
    counts["k10"] += pooled - 1
    counts["k10_bwd"] += pooled - 1
    return counts


def pretrain_launches(counts, steps, val_batches=0, nce=0):
    """A pretraining run's launches; ``nce`` the NCE losses a step, which
    at the CC batch's shape take K8's tensor-core body: a plan, a forward
    and a backward each."""
    return expect(attention_dropout_fwd=counts["attn"] * steps,
                  attention_dropout_bwd=counts["attn_bwd"] * steps,
                  attention_fwd=counts["attn"] * val_batches,
                  nce_plan=nce * steps, nce_scores_fwd=nce * steps,
                  nce_scores_bwd=nce * steps, **k10_of(counts, steps))


_CC_SETS = {}


def cc_dataset(cc_dir, feat_dtype, num_locs):
    """The packed training set at train.sh's lengths (objective 1), packed
    once a dtype and box width (``num_locs``: 5, or LXMERT's 4); a
    batch's global row follows the dataset's ``add_global_imgfeat``, which
    ``cc_batch_on_card`` sets."""
    from volta_tpu_torch.data.datasets.concap import ConceptCapDataset
    from volta_tpu_torch.data.tokenization import BertTokenizer

    key = (cc_dir, feat_dtype, num_locs)
    if key not in _CC_SETS:
        ds = ConceptCapDataset(
            os.path.join(cc_dir, "imgfeats", "training_feat_all.lmdb"),
            os.path.join(cc_dir, "annotations", "caption_train.json"),
            BertTokenizer(os.path.join(cc_dir, "vocab.txt")),
            seq_len=CC_SEQ, region_len=CC_REGIONS, objective=1,
            num_locs=num_locs, seed=0)
        ds.enable_packed(cache=False, feat_dtype=feat_dtype)
        _CC_SETS[key] = ds
    return _CC_SETS[key]


def pretrain_model(cfg, dtype, seed=0):
    import torch

    from volta_tpu_torch.models import VoltaForVLPreTraining
    from volta_tpu_torch.models.layers import init_weights

    cfg.compute_dtype = dtype
    model = VoltaForVLPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.cuda()


def pretrain_grads(model, cfg, batch, objective=1):
    """(loss, every gradient in float32) of one pretraining batch: the
    step's forward (dropout seed 0, the NCE generator seeded 0) and its
    backward, no optimizer."""
    import torch

    from volta_tpu_torch.train_step import _nce_generator, _pretrain_losses

    lm, il = batch["lm_label_ids"], batch["image_label"]
    if objective == 1:
        keep = (batch["is_match"] == 0)[:, None]
        lm, il = torch.where(keep, lm, -1), torch.where(keep, il, -1)
    terms = _pretrain_losses(model, cfg, batch, lm, il,
                             _nce_generator(cfg, "cuda", 0), dropout_seed=0)
    loss = sum(terms)
    loss.backward()
    out = {n: p.grad.float().clone() for n, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def cc_batch_on_card(cc_dir, cfg, feat_dtype, n=CC_BATCH):
    """The first ``n`` images as a batch of ``cfg``'s layout (its global
    row) on the card, the features and soft targets in ``feat_dtype``."""
    from volta_tpu_torch.eval_step import to_device

    ds = cc_dataset(cc_dir, feat_dtype, cfg.num_locs)
    ds.add_global_imgfeat = cfg.add_global_imgfeat
    return to_device(ds.get_batch(np.arange(n)), "cuda")


def hold_pretrain_grads(tag, cfg, batch, want):
    """bf16 gradients of one batch through the kernels (exact launches
    ``want``) against the twins, within NOISE_FACTOR times the twins'
    distance from the twins with float64 attention sums, at least
    GRAD_TOL, as phase 13 holds the fine-tuning step."""
    import torch

    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    model = pretrain_model(cfg, "bfloat16").train()
    reset_launches()
    lk, gk = pretrain_grads(model, cfg, batch)
    counts = dict(LAUNCHES)
    if counts != want:
        raise RuntimeError(f"{tag} gradients launched {counts}, expected "
                           f"{want}")
    with twins():
        lt, gt = pretrain_grads(model, cfg, batch)
    with twins(), float64_attention():
        l64, g64 = pretrain_grads(model, cfg, batch)
    (noise, nworst), (diff, worst) = (grad_distance(g64, gt),
                                      grad_distance(gk, gt))
    tol = max(GRAD_TOL, NOISE_FACTOR * noise)
    print(f"bf16 pretraining gradients ({tag}): kernels vs plain twins "
          f"{diff:.3e} at {worst} (tol {tol:.3e}), twins vs float64 "
          f"attention sums {noise:.3e} at {nworst}; loss {lk:.6f} / "
          f"{lt:.6f} / {l64:.6f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if not (np.isfinite(lk) and all(bool(torch.isfinite(g).all())
                                    for g in gk.values())):
        raise RuntimeError(f"non-finite {tag} gradients")
    if diff > tol:
        raise RuntimeError(f"{tag} gradients disagree with the twins")
    del model
    torch.cuda.empty_cache()


def fp32_pretrain_step(cfg, batch, want):
    """Phase 19 (b): one fp32 pretrain step (objective 1) through the
    kernels (exact launches ``want``) and through the twins from the same
    weights and seeds: losses within 1e-5, parameters within STEP_TOL of
    the largest update, as phase 13 holds the fine-tuning step."""
    import torch

    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_pretrain_step

    model = pretrain_model(cfg, "float32").train()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext), ("twin", twins)):
        model.load_state_dict(init)
        opt = build_optimizer("adamw", 1e-4, model, clip_norm=5.0)
        state = create_train_state(model, opt, seed=11)
        step = make_pretrain_step(model, opt, cfg, objective=1)
        reset_launches()
        with ctx():
            m = step(state, batch)
        res[route] = ({k: float(v) for k, v in m.items()},
                      {k: v.clone() for k, v in model.state_dict().items()},
                      dict(LAUNCHES))
    (mk, pk, counts), (mt, pt, _) = res["kernel"], res["twin"]
    if counts != want:
        raise RuntimeError(f"fp32 pretrain step launched {counts}, "
                           f"expected {want}")
    upd = max(float((pk[n] - init[n]).abs().max()) for n in pk)
    diff = max(float((pk[n] - pt[n]).abs().max()) for n in pk)
    print(f"fp32 pretrain step b{CC_BATCH}, kernels vs twins: {mk} vs {mt}, "
          f"params max abs diff {diff:.3e} (largest update {upd:.3e}, tol "
          f"{STEP_TOL:g} of it)", flush=True)
    if not (all(abs(mk[k] - mt[k]) <= 1e-5 * max(abs(mt[k]), 1e-12)
                for k in mk) and diff <= STEP_TOL * upd
            and np.isfinite(mk["loss"])):
        raise RuntimeError("fp32 pretrain step disagrees with the twins")
    del model, init, res
    torch.cuda.empty_cache()


def no_plan(neg_idx, m):
    """No plan: what the K8-only swaps put in ``nce_plan``'s place, whose
    stand-ins need none."""
    return None


def k8_only_twin():
    """K8's plain twins in its wrappers' place, every other kernel kept."""
    from volta_tpu_torch.ops import nce

    return swapped([(nce, "nce_plan", no_plan),
                    (nce, "nce_scores_fwd", nce.dense_neg_scores),
                    (nce, "nce_scores_bwd", nce.nce_scores_bwd_ref)])


@contextlib.contextmanager
def swapped(swaps):
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def embedding_bag_bwd(g, flat, idx):
    """K8's backward as one torch call: each query's sampled rows of flat
    summed with weights g rounded to flat's dtype, [Q, d]."""
    import torch.nn.functional as F

    q = idx.numel() // idx.shape[-1]
    return F.embedding_bag(idx.reshape(q, -1), flat, mode="sum",
                           per_sample_weights=g.reshape(q, -1).to(flat.dtype))


def library_neg_scores(pred, flat, neg_idx, plan=None):
    """What JAX runs in K8's place, in torch calls: the all-pairs product
    in the inputs' dtype (float32 sums, the scores rounded to that dtype),
    the sampled scores gathered, as float32 (``plan`` unused)."""
    import torch

    return torch.gather(torch.matmul(pred, flat.t()), -1,
                        neg_idx.long()).float()


def library_neg_scores_bwd(g, pred_shape, flat, neg_idx, plan=None):
    """Its transpose as JAX's vjp takes it: g rounded to flat's dtype,
    scattered into the [Q, M] score cotangent in that dtype, times flat in
    that dtype (float32 sums; ``plan`` unused)."""
    import torch

    q = neg_idx.numel() // neg_idx.shape[-1]
    gs = g.reshape(q, -1).to(flat.dtype)
    full = gs.new_zeros((q, flat.shape[0])).scatter_add_(
        1, neg_idx.reshape(q, -1).long(), gs)
    return torch.matmul(full, flat).view(pred_shape)


def k8_body(body):
    """K8's wrappers held to one body, "tc" or "gather", whatever the
    shape: ``nce_body``'s crossover moved past every shape or below it."""
    from volta_tpu_torch.ops import nce

    return swapped([(nce, "TC_MAX_M_PER_NEG",
                     2 ** 31 if body == "tc" else 0)])


def k8_only_library():
    """JAX's composition (``library_neg_scores``) in K8's wrappers' place,
    every other kernel kept."""
    from volta_tpu_torch.ops import nce

    return swapped([(nce, "nce_plan", no_plan),
                    (nce, "nce_scores_fwd", library_neg_scores),
                    (nce, "nce_scores_bwd", library_neg_scores_bwd)])


def k8_flips(got, ref, ref64, lib):
    """The bf16 score check: ``got``'s flips against ``ref64`` (the
    float64-sum scores rounded to bf16) at most K8_FLIP_FACTOR times the
    more of the float32 twin's (``ref``) and torch's bf16 all-pairs
    product's (``lib``), on the same inputs; every score within one bf16
    ulp of torch's product's or of the float64 sums'. (Not of the float32
    twin's: where a sum nearly cancels, the tensor cores' float32 sums,
    torch's and the kernel's alike, land hundreds of that small score's
    ulps from the twin's.) Returns (ok, note)."""
    flips, flips32, flips_lib = (int((x != ref64).sum())
                                 for x in (got, ref, lib))
    limit = K8_FLIP_FACTOR * max(flips32, flips_lib)
    near = ulp_off(got, lib) <= 1.0
    near |= ulp_off(got, ref64) <= 1.0
    ok = flips <= limit and bool(near.all())
    n = got.numel()
    return ok, (f"{flips} flips of {n} against the float64-sum scores "
                f"({flips / n:.2e}; limit {limit:g}: {K8_FLIP_FACTOR:g} x "
                f"the float32 twin's {flips32} or torch's bf16 all-pairs "
                f"product's {flips_lib}), {int((got != lib).sum())} scores "
                f"off torch's bf16 product, {int((~near).sum())} more than "
                f"a bf16 ulp from both it and the float64 sums, at most "
                f"{float(ulp_off(got, ref).max()):.2f} ulps from the "
                f"float32 twin")


def ulp_off(got, ref):
    """|got - ref| in bf16 ulps of each ``ref``."""
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    return (got - ref).abs() / ulp


def check_k8():
    """Phase 19 (c): K8 forward and backward against its twins, bf16 and
    fp32, at K8_SHAPES on JAX's sampled negatives (``sample_negatives``),
    by each body that takes the dtype (the tensor-core body in bf16, the
    gather body in both; ``nce_body`` routes b256 to the first and b512 to
    the second): fp32 scores and gradients within K8_TOL of the largest;
    bf16 scores within ``k8_flips``' bounds and 2^-7 of the largest, bf16
    gradients within K8_TOL (the gather body's scores, with float64 sums,
    at most K8_FLIPS of them off the float64 sums' rounding); two calls of
    each body (``k8_body``) equal to the bit, and
    their launches exact (a plan a call for the tensor-core body). At b256
    bf16: the plan against its twin array for array, the peak memory that
    K8's autograd Function adds forward and backward (at most a third of
    the [Q, M] bf16 score tensor it avoids), and the times (``kernel_ms``)
    of the plan, both bodies, the twins, torch's all-pairs bf16 matmul +
    gather (the forward's library call), JAX's composition backward
    (``library_neg_scores_bwd``, scatter + bf16 matmul: the backward's)
    and ``embedding_bag`` with weights; at b512 bf16 the times of both
    bodies, the plan and the two library calls. The bound: pred, flat, the
    indices and the scores once over the memory rate, or the products'
    FMAs over the peak of the body's operations, bf16 tensor for the
    tensor-core body and fp32 for the gather body (the backward's bytes
    and FMAs are as many); the tensor-core body's dense floor, the
    all-pairs product at the bf16 peak, printed beside it."""
    import torch

    from volta_tpu_torch.losses import sample_negatives
    from volta_tpu_torch.ops import LAUNCHES, nce, reset_launches

    out = {}
    for b, r, chunk in K8_SHAPES:
        gen = torch.Generator("cuda").manual_seed(b + r)
        idx = sample_negatives(b, r, K8_NEG, gen, "cuda")
        rng = np.random.RandomState(b)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            pred = torch.from_numpy((rng.randn(b, r, K8_DIM) * 0.05).astype(
                np.float32)).cuda().to(dtype)
            flat = torch.from_numpy(np.abs(rng.randn(b * r, K8_DIM) * 0.5)
                                    .astype(np.float32)).cuda().to(dtype)
            g = torch.from_numpy(rng.randn(b, r, idx.shape[-1]).astype(
                np.float32)).cuda()
            ref = nce.neg_scores_ref(pred, flat, idx, chunk)
            dref = nce.nce_scores_bwd_ref(g, pred.shape, flat, idx)
            if dt == "bfloat16":
                # the scores with float64 sums, rounded as the kernels
                # round; torch's bf16 all-pairs product (JAX's composition)
                ref64 = torch.gather(torch.matmul(
                    pred.double(), flat.double().t()), -1, idx).float().to(
                        dtype).float()
                lib = library_neg_scores(pred, flat, idx)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            for body in ("gather",) if dt == "float32" else ("tc", "gather"):
                reset_launches()
                with k8_body(body):
                    got = nce.nce_scores_fwd(pred, flat, idx)
                    dgot = nce.nce_scores_bwd(g, pred.shape, flat, idx)
                    again = nce.nce_scores_fwd(pred, flat, idx)
                    dagain = nce.nce_scores_bwd(g, pred.shape, flat, idx)
                torch.cuda.synchronize()
                launched = tuple(LAUNCHES[k] for k in (
                    "nce_plan", "nce_scores_fwd", "nce_scores_bwd"))
                if launched != (4 * (body == "tc"), 2, 2):
                    raise RuntimeError(f"K8 {body} launched {launched}")
                same = torch.equal(got, again) and torch.equal(dgot, dagain)
                err = float((got - ref).abs().max())
                derr = float((dgot.float() - dref.float()).abs().max()) / \
                    float(dref.float().abs().max())
                what = f"K8 {body} b{b} r{r} d{K8_DIM} {dt}" + (
                    f", blockwise twin of {chunk}" if chunk else "")
                if dt == "float32":
                    ok = err <= K8_TOL[dt] * scale
                    note = f"scores max abs diff {err:.3e} of {scale:.3e}"
                elif body == "gather":
                    flips = int((got != ref64).sum())
                    ok = flips <= K8_FLIPS * got.numel() \
                        and err <= 2 ** -7 * scale
                    note = (f"scores: {flips} flips of {got.numel()} against "
                            f"the float64 sums (limit {K8_FLIPS:g} of all), "
                            f"{int((got != ref).sum())} against the float32 "
                            f"twin, max abs diff {err:.3e} of {scale:.3e}")
                else:
                    ok, note = k8_flips(got, ref, ref64, lib)
                    ok = ok and err <= 2 ** -7 * scale
                    note = (f"scores: {note}, max abs diff {err:.3e} of "
                            f"{scale:.3e}")
                ok = ok and same and derr <= K8_TOL[dt] and bool(
                    torch.isfinite(got).all())
                print(f"{what}: {note}; gradient rel diff {derr:.3e} (tol "
                      f"{K8_TOL[dt]:g}); two calls equal to the bit: {same}",
                      flush=True)
                if not ok:
                    raise RuntimeError(f"{what} disagrees with its twins")
            if dt == "bfloat16" and chunk is None:
                out.update(time_k8(b, r, pred, flat, idx, g, err, dgot, dref))
            del pred, flat, g, got, dgot, ref, dref, again, dagain
            torch.cuda.empty_cache()
    return out


def time_k8(b, r, pred, flat, idx, g, err, dgot, dref):
    """Phase 19 (c)'s K8 times at (b, r) bf16 (``check_k8``); at b256 also
    the plan against its twin, the Function's peak memory and the JSON
    rows' entries."""
    import torch

    from volta_tpu_torch.ops import LAUNCHES, nce, reset_launches

    q, m = b * r, flat.shape[0]
    idx32 = idx.to(torch.int32)
    plan = nce.nce_plan(idx32, m)
    torch.cuda.synchronize()
    t = {"plan": kernel_ms(lambda: nce.nce_plan(idx32, m), iters=20)}
    for body in ("tc", "gather"):
        p = plan if body == "tc" else None
        with k8_body(body):
            t[body + " fwd"] = kernel_ms(lambda: nce.nce_scores_fwd(
                pred, flat, idx32, p), iters=20)
            t[body + " bwd"] = kernel_ms(lambda: nce.nce_scores_bwd(
                g, pred.shape, flat, idx32, p), iters=20)
    t["fwd library"] = kernel_ms(lambda: library_neg_scores(pred, flat, idx),
                                 iters=10)
    t["bwd library"] = kernel_ms(lambda: library_neg_scores_bwd(
        g, pred.shape, flat, idx), iters=10)
    n = idx.numel()
    floor = 2 * q * m * K8_DIM / PEAK_OPS["bf16 tensor"] * 1e3
    # forward: pred, flat, the indices and the scores; backward: the
    # cotangent, the indices, flat and d pred, as many
    nbytes = (pred.numel() + flat.numel()) * 2 + n * 4 * 2
    k8_b = bound(nbytes, 2 * n * K8_DIM, "bf16 tensor")
    gather_b = bound(nbytes, 2 * n * K8_DIM, "fp32")
    power = card_line()
    rule = nce.nce_body(q, m, K8_DIM, torch.bfloat16, idx.shape[-1])
    print(f"K8 b{b} r{r} bf16 [{power}]: tensor-core body plan "
          f"{t['plan']:.4f} + forward {t['tc fwd']:.4f} ms, backward "
          f"{t['tc bwd']:.4f} ms; gather body forward {t['gather fwd']:.4f}"
          f", backward {t['gather bwd']:.4f} ms; torch's bf16 all-pairs "
          f"matmul + gather {t['fwd library']:.4f} ms, JAX's composition "
          f"backward (scatter + bf16 matmul) {t['bwd library']:.4f} ms; "
          f"bound {k8_b[0]:.4f} ms by {k8_b[1]} (the gather body's, at the "
          f"fp32 rate, {gather_b[0]:.4f} ms by {gather_b[1]}), the "
          f"tensor-core body's dense floor {floor:.4f} ms; rule: {rule}",
          flush=True)
    if b != 256:
        return {}
    # the plan against its twin
    twin = nce.nce_plan_ref(idx32, m)
    e = int(twin.starts[-1])
    qt, ct, qp, _, _ = nce.plan_tiles(q, m)
    same = (torch.equal(plan.entries[:e], twin.entries[:e])
            and torch.equal(plan.starts, twin.starts)
            and torch.equal(plan.units[:1 + int(twin.units[0])],
                            twin.units[:1 + int(twin.units[0])])
            and torch.equal(plan.bwd_count, twin.bwd_count)
            and all(torch.equal(plan.bwd_list[x * ct:x * ct + c],
                                twin.bwd_list[x * ct:x * ct + c])
                    for x, c in ((2 * p + h, int(twin.bwd_count[p]))
                                 for p in range(qp) for h in range(2))))
    if not same:
        raise RuntimeError("K8's plan differs from its twin")
    # the peak memory the autograd Function adds, forward and backward
    reset_launches()
    x = pred.detach().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s = nce.NCEScores.apply(x, flat, idx)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s.backward(g)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - base
    scores_bytes = q * m * 2
    launched = {k: LAUNCHES[k] for k in ("nce_plan", "nce_scores_fwd",
                                         "nce_scores_bwd")}
    print(f"K8 b{b} autograd Function: launches {launched}; peak memory "
          f"added {fwd_peak / 2**20:.1f} MiB forward, {bwd_peak / 2**20:.1f}"
          f" MiB backward (d pred {x.numel() * 2 / 2**20:.1f} MiB of it), "
          f"against {scores_bytes / 2**20:.1f} MiB for the [Q, M] bf16 "
          f"scores; its plan equals the twin's", flush=True)
    if launched != {"nce_plan": 1, "nce_scores_fwd": 1, "nce_scores_bwd": 1}:
        raise RuntimeError(f"K8's Function launched {launched}")
    if max(fwd_peak, bwd_peak) > scores_bytes / 3:
        raise RuntimeError("K8's Function allocates too much")
    del s, x
    t["fwd plain"] = kernel_ms(lambda: nce.dense_neg_scores(pred, flat, idx),
                               iters=5)
    t["bwd plain"] = kernel_ms(lambda: nce.nce_scores_bwd_ref(
        g, pred.shape, flat, idx), iters=5)
    t["plan plain"] = kernel_ms(lambda: nce.nce_plan_ref(idx32, m), iters=3)
    t["bag"] = kernel_ms(lambda: embedding_bag_bwd(g, flat, idx), iters=10)
    bag_err = float((embedding_bag_bwd(g, flat, idx).float()
                     - dgot.float().view(-1, K8_DIM)).abs().max())
    print(f"K8 b{b} r{r} bf16 [{power}]: twins forward {t['fwd plain']:.4f}"
          f", backward {t['bwd plain']:.4f}, plan {t['plan plain']:.4f} ms; "
          f"embedding_bag (weighted sum) {t['bag']:.4f} ms, max abs diff to "
          f"K8's gradient {bag_err:.3e}", flush=True)
    shapes = f"[{b}x{r}, {K8_DIM}] x {idx.shape[-1]} bf16"
    plan_bytes = n * 4 + e * 8 + plan.starts.numel() * 4
    common = {"shapes": shapes, "body": "tc"}
    return {
        "nce_plan": {"ms": t["plan"], "plain_ms": t["plan plain"],
                     "library_ms": None, "bound": bound(plan_bytes, 0, "fp32"),
                     "max_abs_err": 0.0, **common},
        "nce_scores_fwd": {"ms": t["tc fwd"], "plain_ms": t["fwd plain"],
                           "library_ms": t["fwd library"], "bound": k8_b,
                           "max_abs_err": err, "gather_ms": t["gather fwd"],
                           **common},
        "nce_scores_bwd": {"ms": t["tc bwd"], "plain_ms": t["bwd plain"],
                           "library_ms": t["bwd library"], "bound": k8_b,
                           "max_abs_err": float((dgot.float() - dref.float())
                                                .abs().max()),
                           "gather_ms": t["gather bwd"],
                           "embedding_bag_ms": t["bag"], **common}}


def nce_step(cc_dir, power, profile):
    """Phase 19 (c): one b256 bf16 NCE step (ctrl_uniter_base with
    visual_target_weights {"2": 1}) held to the twins as (b), with K8 once
    forward and once backward; its ms against the same step with K8's twins
    (the float32 all-pairs matmul + gather) and with JAX's bf16 composition
    in K8's place (``k8_only_library``), one turn each, and with
    ``profile`` K8's step's device time by kernel family. Returns K8's
    launches of one step."""
    import torch

    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_pretrain_step

    cfg = VoltaConfig.from_json_file(CONFIG)
    cfg.visual_target_weights = {"2": 1.0}
    batch = cc_batch_on_card(cc_dir, cfg, "bfloat16")
    counts = pretrain_counts(cfg)
    hold_pretrain_grads("NCE through K8", cfg, batch,
                        pretrain_launches(counts, 1, nce=1))
    model = pretrain_model(cfg, "bfloat16").train()
    opt = build_optimizer("adamw", 1e-4, model, clip_norm=5.0)
    state = create_train_state(model, opt, seed=11)
    step = make_pretrain_step(model, opt, cfg, objective=1)
    reset_launches()
    step(state, batch)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in ("nce_plan", "nce_scores_fwd",
                                         "nce_scores_bwd")}
    if launches != {"nce_plan": 1, "nce_scores_fwd": 1, "nce_scores_bwd": 1}:
        raise RuntimeError(f"NCE step launched K8 {launches}")
    routes = (("K8", contextlib.nullcontext), ("twin", k8_only_twin),
              ("library", k8_only_library))
    runs = {name: [] for name, _ in routes}
    # one turn each (before phase 22 two rounds of K8, twin, library,
    # library, twin, K8 and each route's device time by family; PERF.md
    # keeps those numbers)
    for name, route in routes:
        with route():
            runs[name].append(cuda_ms(lambda: step(state, batch), iters=3,
                                      warmup=1))
    ms = {name: float(np.median(v)) for name, v in runs.items()}
    print(f"NCE pretrain step b{CC_BATCH} bf16 [{power}]: K8 "
          f"{ms['K8']:.2f} ms/step, its twins (float32 all-pairs matmul + "
          f"gather) {ms['twin']:.2f}, JAX's composition (bf16 all-pairs "
          f"matmul + gather, scatter + bf16 matmul) {ms['library']:.2f} "
          f"(turns {runs})", flush=True)
    if profile:
        # device time by family: the wall times above are paced by the
        # host where it is slower than the card
        profile_device(lambda: step(state, batch), ms["K8"],
                       "NCE pretrain step", top=10)
    del model, opt, state
    torch.cuda.empty_cache()
    return launches


def mlm_head_ms(batch_rows, power):
    """The MLM decoder and its log-softmax alone at the step's shape: the
    tied [rows, 768] x [768, 30522] bf16 product, the float32 log-softmax
    cross entropy and their backward, ms (CUDA events)."""
    import torch

    from volta_tpu_torch.losses import cross_entropy_ignore

    x = torch.randn(batch_rows, 768, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    table = torch.randn(30522, 768, device="cuda") * 0.02
    table.requires_grad_()
    bias = torch.zeros(30522, device="cuda", requires_grad=True)
    labels = torch.randint(-1, 30522, (batch_rows,), device="cuda")

    def run():
        logits = torch.nn.functional.linear(x, table.to(x.dtype),
                                            bias.to(x.dtype))
        cross_entropy_ignore(logits, labels).backward()

    ms = cuda_ms(run, iters=10, warmup=2)
    print(f"MLM decoder + log-softmax, forward and backward, {batch_rows} "
          f"rows [{power}]: {ms:.3f} ms", flush=True)
    return ms


def pretrain_cli(root, cc_dir, power, profile):
    """Phase 19 (a): the train CLI (train.sh's flags, --in_memory, two
    epochs of 4 steps and their validation) with exact launches, its CC
    lines and val losses; then ms/step of the same step (10 steps) and
    peak, and with ``profile`` its idle share and device ms by family and
    the MLM head timed alone. Returns the CLI's launches and its
    checkpoint."""
    import torch

    from volta_tpu_torch import train_concap
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import build_optimizer, \
        warmup_linear_schedule
    from volta_tpu_torch.train_step import create_train_state, \
        make_pretrain_step

    cfg = VoltaConfig.from_json_file(CONFIG)
    counts = pretrain_counts(cfg)
    reset_launches()
    t0 = time.time()
    summary = train_concap.main(concap_argv(root, cc_dir, 2))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    steps = summary["steps"]
    with open(os.path.join(summary["log_dir"], "out.txt")) as f:
        lines = [ln.strip() for ln in f if " CC masked_t " in ln]
    print(f"train_concap.main: {steps} steps at b{CC_BATCH}, {wall:.1f} s "
          f"wall (packing, model set-up and checkpoints included), val "
          f"losses {summary['val_losses']}, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for ln in lines:
        print(f"  {ln}", flush=True)
    want = pretrain_launches(counts, steps, val_batches=2)
    per_epoch = CC_IMAGES[0] // CC_BATCH
    if steps != 2 * per_epoch or not lines or len(summary["train_losses"]) \
            != steps or not np.all(np.isfinite(summary["train_losses"])) \
            or len(summary["val_losses"]) != 2 \
            or not np.all(np.isfinite(summary["val_losses"])):
        raise RuntimeError(f"train_concap: {summary}")
    if launches != want:
        raise RuntimeError(f"train_concap launched {launches}, expected "
                           f"{want}")
    ckpt = os.path.join(summary["run_dir"], "ckpt", "train_state.pt")

    # the same step timed alone
    batch = cc_batch_on_card(cc_dir, cfg, "bfloat16")
    model = pretrain_model(cfg, "bfloat16").train()
    opt = build_optimizer("adamw", warmup_linear_schedule(1e-4, 10, 1000),
                          model, clip_norm=5.0, betas=(0.9, 0.999))
    state = create_train_state(model, opt, seed=11)
    step = make_pretrain_step(model, opt, cfg, objective=1)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=2)
    print(f"pretrain step b{CC_BATCH} L {CC_SEQ}+{CC_REGIONS + 1} bf16 "
          f"(KL, objective 1): {ms:.2f} ms/step, "
          f"{CC_BATCH / ms * 1e3:.1f} pairs/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{power}]",
          flush=True)
    if profile:
        profile_device(lambda: step(state, batch), ms, "pretrain step",
                       top=25)
        mlm_head_ms(CC_BATCH * CC_SEQ, power)
    del model, opt, state
    torch.cuda.empty_cache()
    return launches, ckpt, batch


def from_pretrained_task(root, data_dir, yml, ckpt):
    """Phase 19 (a): train_task --from_pretrained of the pretraining
    checkpoint for one VQA epoch: its report names the trunk loaded and the
    cls heads left out (and the VQA head at init)."""
    import logging

    from volta_tpu_torch import train_task

    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    log = logging.getLogger("volta_tpu_torch.train_task")
    log.addHandler(handler)
    old = log.level
    log.setLevel(logging.INFO)
    try:
        summary = train_task.main(train_argv(
            root, data_dir, yml, CONFIG, 1, "from_concap")
            + ["--from_pretrained", ckpt])
    finally:
        log.removeHandler(handler)
        log.setLevel(old)
    report = [m for m in records if m.startswith("loaded ")]
    print(f"train_task --from_pretrained {os.path.basename(ckpt)}: "
          f"{report}; {summary['steps']} steps, losses "
          f"{[round(l, 4) for l in summary['train_losses']]}, val scores "
          f"{summary['val_scores']}", flush=True)
    if len(report) != 1 or "['clf_TASK1']" not in report[0] \
            or "unused ['cls']" not in report[0] \
            or not np.all(np.isfinite(summary["train_losses"])):
        raise RuntimeError(f"train_task --from_pretrained: {report}")


def family_pretrain_steps(root, cc_dir):
    """Phase 19 (d): one bf16 pretraining step's gradients of lxmert.json
    (criteria 3-5, fusion text) and vl-bert_base.json (criterion 6, fusion
    none: no ITM head, the global row last) at 4 layers a stream, held to
    the twins as (b), launches from the plan."""
    from volta_tpu_torch.config import VoltaConfig

    for name, keep in PRETRAIN_CUTS.items():
        cfg = VoltaConfig.from_json_file(cut_config(root, name, keep))
        batch = cc_batch_on_card(cc_dir, cfg, "bfloat16")
        hold_pretrain_grads(f"{name} at 4 layers a stream", cfg, batch,
                            pretrain_launches(pretrain_counts(cfg), 1))


def pretrain_export(root, ckpt):
    """Phase 19 (e): the CLI's trained pretraining model exported as a
    reference .bin and read back into other weights: every parameter and
    the eval logits bit for bit."""
    import torch

    from volta_tpu_torch import checkpoint as ck
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.models import VoltaForVLPreTraining

    cfg = VoltaConfig.from_json_file(CONFIG)
    src = pretrain_model(cfg, "bfloat16", seed=0)
    src.load_state_dict(torch.load(ckpt, map_location="cuda",
                                   weights_only=True)["model"])
    path = ck.save_reference_checkpoint(os.path.join(root, "pretrain.bin"),
                                        cfg, src)
    dst = pretrain_model(cfg, "bfloat16", seed=5)
    report = ck.from_pretrained(cfg, dst, path)
    same = all(torch.equal(a, b) for a, b in zip(
        src.state_dict().values(), dst.state_dict().values()))
    print(f"pretraining model exported to a reference .bin "
          f"({os.path.getsize(path) / 2**20:.1f} MiB) and read back: "
          f"{len(report['loaded'])} tensors, skipped {report['skipped']}, "
          f"parameters bit-equal {same}", flush=True)
    if report["skipped"] or not same or not isinstance(
            dst, VoltaForVLPreTraining):
        raise RuntimeError("the pretraining .bin does not round-trip")


def check_pretraining(root, data_dir, yml, power, profile):
    """Phase 19. Returns K8's results and the launches of its runs."""
    from volta_tpu_torch.config import VoltaConfig

    cc_dir = os.path.join(root, "cc")
    t0 = time.time()
    write_synth_cc(cc_dir, *CC_IMAGES, seed=19)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
               os.walk(cc_dir) for f in fs)
    print(f"synthetic Conceptual Captions: {CC_IMAGES[0]} train and "
          f"{CC_IMAGES[1]} valid images, {size / 2**30:.2f} GiB, written in "
          f"{time.time() - t0:.1f} s", flush=True)
    cli_launches, ckpt, batch = pretrain_cli(root, cc_dir, power, profile)
    from_pretrained_task(root, data_dir, yml, ckpt)
    # (b) the b256 step against the twins: fp32, then bf16 gradients
    cfg = VoltaConfig.from_json_file(CONFIG)
    counts = pretrain_counts(cfg)
    fp32_pretrain_step(cfg, cc_batch_on_card(cc_dir, cfg, "float32"),
                       pretrain_launches(counts, 1))
    _CC_SETS.pop((cc_dir, "float32", cfg.num_locs))
    hold_pretrain_grads("ctrl_uniter_base, KL", cfg, batch,
                        pretrain_launches(counts, 1))
    # (c) K8 and the NCE step, (d) two other families, (e) the export
    results = check_k8()
    nce_launches = nce_step(cc_dir, power, profile)
    family_pretrain_steps(root, cc_dir)
    pretrain_export(root, ckpt)
    return results, {"cli": cli_launches, "nce": nce_launches}


# ----------------------------------------------------------------- phase 20
# the retrieval CLI at examples/ctrl_uniter/flickr30k/test.sh's width: a
# 1000-image gallery (two chunks of 500) of 36 regions x 2048, 38 tokens
# (L = 38 + 36 + 1 = 75), 4 captions a dispatch (2,000 pairs), 64 captions
RET_IMAGES, RET_SEQ, RET_CAPTIONS, RET_CB = 1000, 38, 64, 4
# K9 alone: a dispatch's products (M = 4 x 500 x 75 rows; K x N of the
# attention projections, FFN1 and FFN2), and odd shapes
K9_M = 4 * 500 * 75
K9_MAIN = ((768, 768), (768, 3072), (3072, 768))
K9_ODD = [(m, k, n) for m in (7, 1000, 150_001) for k in (5, 100)
          for n in (1, 100)] + [(150_001, 768, 100)]
# RAdam's update on the card against the CPU's, relative
RADAM_TOL = 1e-6


def retrieval_dataroot(root):
    """Phase 20's Flickr30k test split: 1000 images of 36 boxes, 5
    captions each, TASK8 of ``ctrl_test_tasks.yml`` at 38 tokens. Returns
    the yml and the vocab."""
    ret = os.path.join(root, "flickr30k_test")
    t0 = time.time()
    os.makedirs(ret, exist_ok=True)
    write_synth_features(ret, RET_IMAGES, 36, 2048,
                         np.random.RandomState(20))
    write_synth_retrieval(ret, images=RET_IMAGES, sentences=5, seed=20)
    yml = os.path.join(root, "retrieval_test.yml")
    with open(yml, "w") as f:
        f.write(f"""TASK8:
  name: RetrievalFlickr30k
  type: VL-logit
  num_labels: 1
  loss: CrossEntropyLoss
  process: retrieval
  task_id: 8
  dataroot: {ret}
  features_h5path1: {ret}/features.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: {ret}/{RETRIEVAL_ANN}
  val_annotations_jsonpath: {ret}/{RETRIEVAL_ANN}
  max_seq_length: {RET_SEQ}
  max_region_num: 36
  batch_size: 1
  train_split: train
  val_split: test
  lr: 0.00002
""")
    print(f"synthetic Flickr30k test split: {RET_IMAGES} images x 5 "
          f"captions, written in {time.time() - t0:.1f} s", flush=True)
    return yml, os.path.join(ret, "vocab.txt")


def dense_calls(model, fn):
    """The Dense modules' calls during ``fn()``, counted by forward
    hooks."""
    from volta_tpu_torch.ops.int8_dense import dense_modules

    calls = [0]
    hooks = [m.register_forward_hook(lambda *_: calls.__setitem__(
        0, calls[0] + 1)) for m in dense_modules(model).values()]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return calls[0]


def run_retrieval(root, yml, vocab, path, power):
    """Phase 20 (a): ``eval_retrieval.main`` plain (bf16), ``--zero_shot``
    and ``--quantize int8`` on one .bin, ``path`` (phase 19's export: the
    trunk and the pretraining heads; the retrieval head stays at its draw
    from the seed, the same in the bf16 and int8 runs); exact launches
    (row 1 12 a forward, K9a and K9b once per Dense a forward), one
    dispatch held to the twins, the int8 one bit-equal with K9 swapped for
    its twins. Returns the runs."""
    import torch

    from volta_tpu_torch import eval_retrieval
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.ops import int8_dense as i8

    base = ["--config_file", CONFIG, "--tasks_config_file", yml,
            "--task", "8", "--vocab_file", vocab, "--from_pretrained", path,
            "--num_workers", "0", "--compute_dtype", "bfloat16",
            "--captions_per_forward", str(RET_CB), "--max_captions",
            str(RET_CAPTIONS), "--device", "cuda", "--seed", "0"]
    attn = plan_counts(task_config(CONFIG, {}))["attn"]
    runs = {}
    for tag, flags in (("bf16", []), ("zero-shot", ["--zero_shot"]),
                       ("int8", ["--quantize", "int8"])):
        reset_launches()
        t0 = time.time()
        out = eval_retrieval.main(base + ["--output_dir", os.path.join(
            root, "retrieval_" + tag)] + flags)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        forwards = out["dispatches"] + 1  # and the warm-up
        scores = out["score_matrix"]
        block = out["captions"](0)
        fwd = out["forward"]
        per = 0
        if tag == "int8":
            served = out["model"]
            per = dense_calls(served, lambda: fwd(block, 0))
            if per != len(i8.dense_modules(served)):
                raise RuntimeError(f"int8: {per} Dense calls a forward, "
                                   f"{len(i8.dense_modules(served))} Dense")
        want = expect(attention_fwd=attn * forwards,
                      int8_quantize=per * forwards,
                      int8_matmul=per * forwards)
        print(f"eval_retrieval.main ({tag}): {RET_CAPTIONS} captions x "
              f"{RET_IMAGES} images in {out['dispatches']} dispatches of "
              f"{RET_CB} x 500 pairs: {out['pairs_per_s']:.1f} pairs/s "
              f"({out['seconds']:.2f} s scoring, {wall:.1f} s wall with "
              f"data and model set-up) [{power}]; image retrieval "
              f"{out['image_retrieval']}, text retrieval "
              f"{out['text_retrieval']}; launches {launches}", flush=True)
        if launches != want:
            raise RuntimeError(f"retrieval {tag} launches {launches}, "
                               f"expected {want}")
        if scores.shape != (RET_CAPTIONS, RET_IMAGES) \
                or not np.isfinite(scores).all():
            raise RuntimeError(f"retrieval {tag}: scores {scores.shape}")
        got = fwd(block, 1).float()
        if tag == "int8":
            # bit-equal to the same dispatch with K9's twins in its place
            with swapped([(i8, "int8_quantize", i8.quantize_ref),
                          (i8, "int8_matmul", i8.int8_matmul_ref)]):
                ref = fwd(block, 1).float()
            same = torch.equal(got, ref)
            print(f"int8 dispatch with K9 vs its twins: bit-equal {same} "
                  f"(max abs diff {float((got - ref).abs().max()):.3e})",
                  flush=True)
            if not same:
                raise RuntimeError("the int8 dispatch disagrees with K9's "
                                   "twins")
        else:
            hold_to_twins(f"retrieval {tag}", got,
                          lambda b: {"prediction": fwd(*b).float()},
                          (block, 1))
        out["launches"] = launches
        runs[tag] = out
    for out in runs.values():  # the served models and galleries go
        for key in ("forward", "model", "gallery", "captions"):
            del out[key]
    torch.cuda.empty_cache()
    agree = float(np.mean(runs["int8"]["score_matrix"].argmax(1)
                          == runs["bf16"]["score_matrix"].argmax(1)))
    diff = float(np.abs(runs["int8"]["score_matrix"]
                        - runs["bf16"]["score_matrix"]).max())
    print(f"int8 vs bf16 route: top-1 image agreement {agree:.4f} over "
          f"{RET_CAPTIONS} captions, max |dscore| {diff:.4f} (random "
          "weights: the scores are near-tied; printed only)", flush=True)
    return runs


def k9_inputs(m, k, n, dtype, seed):
    """x [m, k] of ``dtype`` with rows of scales up to 4 and a zero row (a
    padded token's), a Dense weight [n, k] and bias [n], on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g) \
        * torch.rand(m, 1, device="cuda", generator=g) * 4
    x[m // 2] = 0.0
    w = torch.randn(n, k, device="cuda", generator=g) * 0.05
    b = torch.randn(n, device="cuda", generator=g)
    return x.to(dtype), w, b


def check_k9(power):
    """Phase 20 (b): K9a and K9b against their twins bit for bit at a
    dispatch's three products (M = 150,000) and at odd shapes (M 7, 1000,
    150,001; K 5, 100; N 1, 100; and 150,001 x 768 x 100 on the Hopper
    body) with zero rows, dynamic and static scales, bf16 and float32 in
    and out, and the epilogue's ties on both bodies; the kernels' times at
    the dispatch's shapes beside their twins', the bound and the library:
    ``torch._int_mm`` and the same epilogue, and the bf16 ``F.linear``;
    each shape's K9b body (``int8_body``). Returns the kernels' rows."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import int8_dense as i8

    checked, bodies = 0, {}
    for m, k, n in K9_ODD + [(K9_M, k, n) for k, n in K9_MAIN]:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = k9_inputs(m, k, n, dtype, seed=m + k + n)
            q, scale = i8.quantize_kernel(w)
            for static in (False, True):
                a_s = i8.absmax_scale(x.float().abs().amax()) if static \
                    else None
                xq, a = i8.int8_quantize(x, a_s)
                bodies[(m, k, n)] = i8.int8_body(xq, q)
                rq, ra = i8.quantize_ref(x, a_s)
                if not (torch.equal(xq, rq) and torch.equal(a, ra)) \
                        or int(xq[m // 2].abs().max()):
                    raise RuntimeError(f"K9a {m}x{k} {dtype} static "
                                       f"{static} disagrees with its twin")
                for out in (torch.bfloat16, torch.float32):
                    y = i8.int8_matmul(xq, a, q, scale, b, out)
                    ref = i8.int8_matmul_ref(xq, a, q, scale, b, out)
                    if not torch.equal(y, ref):
                        raise RuntimeError(
                            f"K9b {m}x{k}x{n} {dtype}->{out} static "
                            f"{static}: max abs diff "
                            f"{float((y.float() - ref.float()).abs().max())}")
                    checked += 1
            del x, w, b, q, scale, xq, a, rq, ra
    # the epilogue's ties: acc = +-(2^18 - 1) times a * scale = (2^18 + 1)
    # 2^-60, plus +-(1 + 2^-23), rounds once to +-(1 + 2^-23); rounded
    # through float64 first it would land on the even neighbour. At K 18
    # (the mma.sync body) and zero-padded to K 32 (the same sums, the
    # Hopper body)
    row = [127] * 17 + [15]
    a = torch.full((2,), (2 ** 18 + 1) * 2.0 ** -30, device="cuda")
    scale = torch.full((2,), 2.0 ** -30, device="cuda")
    b = torch.tensor([1 + 2 ** -23, -(1 + 2 ** -23)], device="cuda")
    for k in (18, 32):
        pad = [0] * (k - 18)
        xq = torch.tensor([row + pad, [-v for v in row] + pad],
                          dtype=torch.int8, device="cuda")
        q = torch.tensor([[127] * 16 + [32, 1] + pad] * 2, dtype=torch.int8,
                         device="cuda")
        bodies[("ties", k)] = i8.int8_body(xq, q)
        y = i8.int8_matmul(xq, a, q, scale, b, torch.float32)
        ref = i8.int8_matmul_ref(xq, a, q, scale, b, torch.float32)
        if not (torch.equal(y, ref) and torch.equal(y, b.expand(2, 2))):
            raise RuntimeError(f"K9b's epilogue ties at K {k} "
                               f"({bodies[('ties', k)]}): {y.tolist()}, "
                               f"twin {ref.tolist()}")
        checked += 1
    if {bodies[("ties", 18)], bodies[("ties", 32)]} != {"mma.sync", "wgmma"}:
        raise RuntimeError(f"K9b's ties ran on {bodies}, not on both bodies")
    print(f"K9a and K9b bit-equal to their twins in {checked} cases "
          f"(shapes {K9_ODD} and M {K9_M} x {K9_MAIN}; dynamic and static "
          "scales, bf16 and float32 in and out, a zero row each; and "
          "K9b's epilogue on four float64 ties on each body); K9b's body "
          f"by shape: {bodies}", flush=True)

    rows = {}
    for k, n in K9_MAIN:
        x, w, b = k9_inputs(K9_M, k, n, torch.bfloat16, seed=k * n)
        q, scale = i8.quantize_kernel(w)
        xq, a = i8.int8_quantize(x)
        qa_ms = kernel_ms(lambda: i8.int8_quantize(x), iters=50)
        qa_plain = cuda_ms(lambda: i8.quantize_ref(x), iters=5, warmup=1)
        qa_bound = bound(K9_M * k * 2 + K9_M * k + 4 * K9_M, 0,
                         "int8 tensor")
        mm_ms = kernel_ms(lambda: i8.int8_matmul(xq, a, q, scale, b,
                                                 torch.bfloat16), iters=20)
        mm_plain = cuda_ms(lambda: i8.int8_matmul_ref(
            xq, a, q, scale, b, torch.bfloat16), iters=3, warmup=1)
        qt = q.t()

        def library():
            acc = torch._int_mm(xq, qt)
            return torch.addcmul(b, acc.float(), a[:, None] * scale) \
                .to(torch.bfloat16)

        lib_ms = kernel_ms(library, iters=20)
        wb = w.to(torch.bfloat16)
        lin_ms = kernel_ms(lambda: F.linear(x, wb, b.to(torch.bfloat16)),
                           iters=20)
        mm_bound = bound(K9_M * k + n * k + 4 * K9_M + 8 * n
                         + K9_M * n * 2, 2 * K9_M * n * k, "int8 tensor")
        body = bodies[(K9_M, k, n)]
        print(f"K9 at M {K9_M}, K {k}, N {n} [{power}]: K9a "
              f"{qa_ms:.4f} ms (twin {qa_plain:.4f}; bound "
              f"{qa_bound[0]:.4f} by {qa_bound[1]}, "
              f"{qa_bound[0] / qa_ms:.3f} of it); K9b ({body}) "
              f"{mm_ms:.4f} ms "
              f"(twin {mm_plain:.4f}; torch._int_mm + epilogue "
              f"{lib_ms:.4f}; bf16 F.linear {lin_ms:.4f}; bound "
              f"{mm_bound[0]:.4f} by {mm_bound[1]}, "
              f"{mm_bound[0] / mm_ms:.3f} of it; "
              f"{2 * K9_M * n * k / mm_ms / 1e9:.1f} TOPS)", flush=True)
        rows[(k, n)] = {
            "int8_quantize": {"max_abs_err": 0.0, "ms": qa_ms,
                              "plain_ms": qa_plain, "bound": qa_bound,
                              "library_ms": None},
            "int8_matmul": {"max_abs_err": 0.0, "ms": mm_ms,
                            "plain_ms": mm_plain, "bound": mm_bound,
                            "library_ms": lib_ms, "bf16_linear_ms": lin_ms,
                            "body": body}}
        del x, w, b, q, scale, xq, a
        torch.cuda.empty_cache()
    # the kernels line: K9a at K 768 (five of a layer's six inputs), K9b at
    # FFN1 (768 x 3072), the others' times beside them
    out = {"int8_quantize": rows[(768, 3072)]["int8_quantize"],
           "int8_matmul": rows[(768, 3072)]["int8_matmul"]}
    for name in out:
        out[name]["shapes"] = {f"{K9_M}x{k}x{n}": {
            key: (r[name][key][0] if key == "bound" else r[name][key])
            for key in ("ms", "plain_ms", "bound", "library_ms", "body")
            if key in r[name]}
            for (k, n), r in rows.items()}
    return out


def radam_on_card():
    """Phase 20 (c): fp32 RAdam updates on the card equal the CPU's within
    RADAM_TOL (relative to each tensor's largest) over steps 1-7, the
    fallback and then the adaptive branch. The parameters are set to 0
    before each step, so that each step's update is read exactly. No clip:
    its float32 global norm over 600k elements sums in another order on
    each device, ~5e-6 apart, which would scale every update by as much."""
    import torch

    from volta_tpu_torch.optimization import RAdam

    g = torch.Generator().manual_seed(20)
    shapes = [(768, 768), (3072,), (5, 768), (1,)]
    grads = [[torch.randn(s, generator=g) for s in shapes] for _ in range(7)]
    params = {d: [torch.zeros(s, device=d, requires_grad=True)
                  for s in shapes] for d in ("cpu", "cuda")}
    opts = {d: RAdam([(str(i), p) for i, p in enumerate(params[d])], 1e-3,
                     eps=1e-6, weight_decay=0.01)
            for d in params}
    worst = 0.0
    for gs in grads:
        for d in params:
            for p, gr in zip(params[d], gs):
                p.data.zero_()
                p.grad = gr.to(d)
            opts[d].step()
        for a, b in zip(params["cpu"], params["cuda"]):
            a, b = a.detach(), b.detach().cpu()
            worst = max(worst, float((a - b).abs().max() / a.abs().max()))
    adaptive = [opts["cpu"].step_sizes(t)[0] for t in range(1, 8)]
    print(f"fp32 RAdam on the card vs the CPU, steps 1-7 (adaptive "
          f"{adaptive}): max relative difference of the updates "
          f"{worst:.3e} (tol {RADAM_TOL})", flush=True)
    if worst > RADAM_TOL or adaptive != [False] * 5 + [True] * 2:
        raise RuntimeError("RAdam on the card disagrees with the CPU")


def optimizer_cli(root, data_dir, yml, config):
    """Phase 20 (c): ``train_task.main`` (ctrl_uniter VQA, b256, one epoch,
    at phase 16's cut depth ``config``, so that its four checkpoints stay
    small on the machine's disk) with ``--optim RAdam
    --optimizer_state_dtype bfloat16 --skip_disconnected_params`` (JAX
    gives RAdam float32 moments whatever the flag) and with
    ``--optimizer_state_dtype bfloat16`` (AdamW's moments in bf16): finite
    losses, exact launches, the saved state's moment dtypes."""
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    counts = plan_counts(task_config(config, {}))
    for tag, flags, dtype in (
            ("radam_bf16_skip", ["--optim", "RAdam", "--optimizer_state_dtype",
                                 "bfloat16", "--skip_disconnected_params"],
             "torch.float32"),
            ("bf16_moments", ["--optimizer_state_dtype", "bfloat16"],
             "torch.bfloat16")):
        argv = train_argv(root, data_dir, yml, config, 1, "optim_" + tag)
        reset_launches()
        t0 = time.time()
        out = train_task.main(argv + flags)
        torch.cuda.synchronize()
        launches, steps = dict(LAUNCHES), out["steps"]
        saved = torch.load(os.path.join(out["run_dir"], "ckpt",
                                        "train_state.pt"), map_location="cpu",
                           weights_only=True)["optimizer"]
        dtypes = {str(saved[k]["clf_TASK1.dense2.weight"].dtype)
                  for k in ("mu", "nu")}
        # the val loop's forwards: the plan's attention launches a batch
        want = expect(attention_dropout_fwd=counts["attn"] * steps,
                      attention_dropout_bwd=counts["attn_bwd"] * steps,
                      **k10_of(counts, steps),
                      attention_fwd=launches["attention_fwd"])
        val_ok = launches["attention_fwd"] > 0 \
            and launches["attention_fwd"] % counts["attn"] == 0
        print(f"train_task.main {' '.join(flags)} ({len(UNITER_CUT) // 2}"
              f" layers): {steps} steps, losses "
              f"{[round(l, 4) for l in out['train_losses']]}, "
              f"{len(out['val_scores'])} val epoch, moments {sorted(dtypes)},"
              f" {time.time() - t0:.1f} s wall, launches {launches}",
              flush=True)
        if launches != want or not val_ok \
                or not np.all(np.isfinite(out["train_losses"])) \
                or not steps or dtypes != {dtype}:
            raise RuntimeError(f"train_task {flags}: launches {launches}, "
                               f"expected {want}; moments {dtypes}")


def optimizer_rates(task_cfg, batch_np, power):
    """Phase 20 (c): ms/step and peak GiB of the b256 bf16 step with
    float32 AdamW, RAdam and AdamW's bf16 moments, one turn each (a, b,
    c; a, b, c, c, b, a before phase 22, whose numbers PERF.md keeps),
    each optimizer built fresh on its turn so that only its state is
    allocated; the moments' GiB. Five warm-up updates: RAdam's updates
    1-5 take its SGD-style fallback, so that every timed one is adaptive."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import RAdam, build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    model = build_model(task_cfg, "bfloat16").train()
    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    routes = {"AdamW float32": ("adamw", None), "RAdam": ("radam", None),
              "AdamW bf16 moments": ("adamw", torch.bfloat16)}
    names = list(routes)
    runs = {n: [] for n in names}
    state_gib = {}
    warm = 5
    for name in names:
        kind, dtype = routes[name]
        opt = build_optimizer(kind, 1e-5, model, clip_norm=1.0,
                              state_dtype=dtype)
        if isinstance(opt, RAdam) and not opt.step_sizes(warm + 1)[0]:
            raise RuntimeError("RAdam's timed updates would take its fallback")
        state_gib[name] = sum(t.numel() * t.element_size()
                              for t in opt.mu + opt.nu) / 2**30
        state = create_train_state(model, opt, seed=11)
        step = make_task_train_step(model, opt, task_cfg, "TASK1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=warm)
        if isinstance(opt, RAdam) and opt.adam_count != warm + 10:
            raise RuntimeError(f"RAdam took {opt.adam_count} updates")
        runs[name].append((ms, torch.cuda.max_memory_allocated() / 2**30))
        del opt, state, step
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    out = {}
    for name, rs in runs.items():
        ms = float(np.median([m for m, _ in rs]))
        peak = max(p for _, p in rs)
        out[name] = (ms, peak)
        print(f"train step b256 bf16 with {name}: median {ms:.2f} ms/step "
              f"(turns {', '.join(f'{m:.2f}' for m, _ in rs)}), peak "
              f"{peak:.2f} GiB, moments {state_gib[name]:.3f} GiB "
              f"[{power}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def skip_disconnected_lxmert(root, data_dir):
    """Phase 20 (c): lxmert.json at phase 18's cut depth, two b32 train
    steps from one init with and without ``skip_disconnected_params``: the
    parameters no gradient reaches (its last vision sublayers under
    ``fusion_method: text``) stay bit-equal to their initial values with
    the flag and move (weight decay) without it; every other parameter
    moves in both."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import build_optimizer, no_decay_mask
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    yml = family_yml(root, data_dir, FAMILY_RUNS["lxmert"])
    config = cut_config(root, "lxmert", PRETRAIN_CUTS["lxmert"])
    task_cfg, _, train_np = family_data(root, data_dir, yml, config,
                                        "lxmert skip")
    batch = to_device(train_np, "cuda")
    finals, dead = {}, None
    for skip in (True, False):
        model = build_model(task_cfg, "bfloat16", config=config).train()
        decays = no_decay_mask(model)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = build_optimizer("adamw", 1e-4, model, clip_norm=1.0,
                              skip_disconnected_params=skip)
        state = create_train_state(model, opt, seed=11)
        step = make_task_train_step(model, opt, task_cfg, "TASK1")
        reached = set()
        real = opt.step

        def spy():
            reached.update(n for n, p in zip(opt.names, opt.params)
                           if p.grad is not None
                           and bool(p.grad.abs().sum() > 0))
            real()

        opt.step = spy
        losses = [float(step(state, batch)["loss"]) for _ in range(2)]
        dead = sorted(set(init) - reached)
        finals[skip] = {n: torch.equal(p.detach(), init[n])
                        for n, p in model.named_parameters()}
        print(f"lxmert.json (cut) skip_disconnected {skip}: losses "
              f"{losses}; {len(dead)} parameters no gradient reached "
              f"({sorted({n.rsplit('.', 1)[0] for n in dead})[:8]}...), "
              f"unchanged after 2 steps "
              f"{sum(finals[skip][n] for n in dead)}; the others unchanged "
              f"{sum(v for n, v in finals[skip].items() if n not in dead)}",
              flush=True)
        del model, opt, state, step
        torch.cuda.empty_cache()
    # without the flag the disconnected parameters that decay move (their
    # LayerNorm parameters and biases take no decay and stay either way)
    decayed = [n for n in dead if decays[n]]
    print(f"without the flag {sum(not finals[False][n] for n in decayed)} "
          f"of the {len(decayed)} decayed disconnected parameters moved",
          flush=True)
    if not dead or not decayed or not all(finals[True][n] for n in dead) \
            or any(finals[False][n] for n in decayed) \
            or any(v for n, v in finals[True].items() if n not in dead) \
            or not all("encoder" in n for n in dead):
        raise RuntimeError("skip_disconnected_params did not hold "
                           "lxmert.json's disconnected vision tail")


def trunk_lr_scale(root, cc_dir, config):
    """Phase 20 (d): ``train_concap`` at phase 16's cut depth ``config``
    from phase 19's exported .bin (its first layers, its ``cls`` heads left
    out), for 2 steps (the first at lr 0, warmup 1)
    with and without ``--trunk_lr_scale 0.1``: each loaded parameter's
    update is 0.1x the unscaled one, within 1e-6 relative beyond the
    rounding of p + u (half an ulp of each parameter); the heads (not
    loaded) move alike, bit for bit."""
    import torch

    from volta_tpu_torch import train_concap

    sd = torch.load(os.path.join(root, "pretrain.bin"), map_location="cpu",
                    weights_only=True)
    # the trunk's tensors that the cut model reads: no cls heads, the
    # first layers
    layers = len(UNITER_CUT) // 2
    trunk = os.path.join(root, "pretrain_trunk.bin")
    torch.save({k: v for k, v in sd.items() if not k.startswith("cls.")
                and int((re.search(r"\.layer\.(\d+)\.", k)
                         or [0, 0])[1]) < layers}, trunk)
    del sd
    runs = {}
    for tag, flags in (("scaled", ["--trunk_lr_scale", "0.1"]),
                       ("unscaled", [])):
        argv = concap_argv(root, cc_dir, 1, config=config) + [
            "--output_dir", os.path.join(root, "cc_trunk_" + tag),
            "--in_memory", "",
            "--from_pretrained", trunk, "--steps_per_epoch", "2",
            "--warmup_steps", "1", "--device", "cuda"] + flags
        out = train_concap.main(argv)
        runs[tag] = torch.load(os.path.join(
            out["run_dir"], "ckpt", "train_state.pt"), map_location="cpu",
            weights_only=True)["model"]
        loaded = set(out["pretrained"]["loaded"])
        print(f"train_concap {' '.join(flags) or '(no scale)'}: "
              f"{out['steps']} steps, losses {out['train_losses']}, "
              f"{len(loaded)} tensors loaded", flush=True)
    from volta_tpu_torch import checkpoint as ck
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.models import VoltaForVLPreTraining
    from volta_tpu_torch.optimization import flax_paths

    cfg = VoltaConfig.from_json_file(config)
    with torch.device("cuda"):
        start = VoltaForVLPreTraining(cfg)
    ck.from_pretrained(cfg, start, trunk)  # the loaded parameters' start
    paths = flax_paths(start)
    start = {k: v.cpu() for k, v in start.state_dict().items()}
    worst, n_loaded, n_other = 0.0, 0, 0
    for name, p_s in runs["scaled"].items():
        p_u = runs["unscaled"][name]
        if name in paths and ".".join(paths[name]) in loaded:
            p0 = start[name]
            d_s, d_u = (p_s - p0).double(), (p_u - p0).double()
            want = 0.1 * d_u
            slack = 0.5 * (spacing(p_s) + 0.1 * spacing(p_u))
            excess = ((d_s - want).abs() - slack).clamp(min=0)
            worst = max(worst, float((excess / want.abs().clamp(
                min=1e-30)).max()))
            n_loaded += 1
        else:
            if not torch.equal(p_s, p_u):
                raise RuntimeError(f"{name} (not loaded) moved otherwise "
                                   "under --trunk_lr_scale")
            n_other += 1
    print(f"--trunk_lr_scale 0.1: {n_loaded} loaded parameters' updates "
          f"0.1x the unscaled ones (largest relative excess over the "
          f"rounding of p + u {worst:.3e}, tol 1e-6); {n_other} parameters "
          "not loaded moved alike, bit for bit", flush=True)
    if not n_loaded or not n_other or worst > 1e-6:
        raise RuntimeError("--trunk_lr_scale did not scale the loaded "
                           "parameters' updates by 0.1")


def spacing(t):
    """Each element's float32 ulp, in float64."""
    import torch

    t = t.float()
    return (torch.nextafter(t.abs(), torch.full_like(t, float("inf")))
            - t.abs()).double()


RANGE_NAME = re.compile(r"(step|attn|ff)_\d+")


def profile_device(fn, call_ms, what, calls=3, top=40):
    """Device time of ``fn()`` (a train step or an eval forward) by kernel
    (torch.profiler) over ``calls`` calls after the timing runs, and the
    device's idle share against the unprofiled ``call_ms`` (the profiler
    slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / calls * 1e3
    rows = []
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", None)
        if dev is None:
            dev = getattr(evt, "cuda_time_total", 0)
        # the port's ranges (step_<n>, attn_<i>, ff_<i>) carry the device
        # time of the kernels inside them: not kernels, and counted once
        if getattr(evt, "is_user_annotation", False) \
                or RANGE_NAME.fullmatch(evt.key):
            continue
        if dev and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / calls / 1e3, evt.count // calls, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile ({what}): {wall:.3f} ms a call on the host clock while "
          f"profiled, {total:.3f} ms of device time a call; idle share "
          f"{max(0.0, 1 - total / call_ms):.3f} of the unprofiled "
          f"{call_ms:.3f} ms a call", flush=True)
    families = {}
    for ms, _, key in rows:
        fam = next((f for f, words in KERNEL_FAMILIES
                    if any(w in key for w in words)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    for fam, ms in sorted(families.items(), key=lambda x: -x[1]):
        print(f"  family {fam}: {ms:.3f} ms {100 * ms / total:.1f}%",
              flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}% x{count:<4d} "
              f"{key[:110]}", flush=True)
    return total



# phase 21: the serving exporter, --profile_steps and use_scan
def serving_batch(cfg, b, seq_len, region_len, seed):
    """A batch of the exported forward's six inputs on the card, in the
    artifact's dtypes (``export.eval_arg_specs``): random tokens with a
    padded tail, features and boxes, a few padded regions."""
    import torch

    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (b, seq_len)).astype(np.int32)
    t_mask = np.ones((b, seq_len), np.int32)
    t_mask[:, seq_len - rng.randint(0, seq_len // 2):] = 0
    v_mask = np.ones((b, region_len), np.int32)
    v_mask[::3, region_len - 4:] = 0
    arrays = [ids * t_mask,
              (rng.randn(b, region_len, cfg.v_feature_size) * 0.5)
              .astype(np.float32),
              rng.rand(b, region_len, cfg.num_locs).astype(np.float32),
              np.zeros((b, seq_len), np.int32), t_mask, v_mask]
    return [torch.from_numpy(a).cuda() for a in arrays]


def port_kernel_names(fn, tries=3):
    """The names of the port's kernels that the profiler records over one
    call of ``fn`` (after a warm-up call in the same session, as
    ``profile_device``), as a sorted list with repeats; a session with no
    device record at all is tried again, up to ``tries`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    port = ("attention_", "layer_norm_", "dropout_residual_ln_",
            "band_sum_kernel", "int8_", "quantize_kernel",
            "hash_dropout_kernel", "keep_mask_kernel")
    for _ in range(tries):
        events = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: events.extend(p.events())) \
                as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return sorted(n for n in names if any(w in n for w in port))
    raise RuntimeError("the profiler recorded no device kernel in "
                       f"{tries} sessions")


def export_cli(root, yml, config, tag, *flags, check=True):
    """``python -m volta_tpu_torch.tools.export_model``'s ``main()`` for
    ctrl_uniter_base VQA (random weights from seed 0), batch symbol b,
    with ``--check`` unless ``check`` is false; its result and the
    artifact's size."""
    from volta_tpu_torch.tools import export_model

    out = os.path.join(root, f"vqa_{tag}.pt2")
    res = export_model.main([
        "--config_file", config, "--tasks_config_file", yml, "--task", "1",
        "--out", out, "--batch_size", "b", "--compute_dtype", "bfloat16",
        "--device", "cuda", *(["--check"] if check else []), *flags])
    res["mib"] = os.path.getsize(out) / 2**20
    load = "" if res["load_s"] is None else f", load {res['load_s']:.2f} s"
    print(f"export_model ({tag}{''.join(' ' + f for f in flags)}): export "
          f"{res['export_s']:.2f} s{load}, {res['mib']:.1f} MiB, platforms "
          f"{res['exported'].platforms}", flush=True)
    return res


def check_export(root, yml, power, flagged):
    """Phase 21 (a): the serving exporter on ctrl_uniter_base VQA at full
    width (12 layers, L 23 + 37), bf16, through its CLI. The kernel
    artifact (``--use_pallas``, batch symbol b, parameterized), loaded,
    against the live forward at b256 and b1024: logits bit-equal, the
    port's launch counts equal (12 of row 1 a forward) and the profiler's
    port kernels equal; the same with both LayerNorm flags (12 of row 1,
    29 of row 10); the int8 artifact (bit-equal to the live int8
    forward, K9a and K9b once per Dense: 78 + 78); the portable artifact
    (no kernel of the port launches; logits held as phase 9 holds the
    twins); the baked artifact's size on disk (then deleted). Times: the
    export and load seconds, b1024 pairs/s of the loaded artifact and the
    live forward in turns, and one call's host µs through the registered
    op against the eager wrapper. Returns the numbers."""
    import torch

    from volta_tpu_torch.ops import LAUNCHES, attention_cuda, \
        reset_launches
    from volta_tpu_torch.ops import int8_dense as pint8

    stats = {}
    res = export_cli(root, yml, CONFIG, "kernels", "--use_pallas")
    model, params, back = res["model"], res["params"], res["loaded"]
    cfg = model.cfg
    seq_len, region_len = res["zeros"][0].shape[1], res["zeros"][1].shape[1]
    live = lambda b: model(b[0], b[1], b[2], "TASK1", *b[3:])  # noqa: E731
    art = lambda b: back.call(params, *b)  # noqa: E731
    stats["export_s"], stats["load_s"] = res["export_s"], res["load_s"]
    batches = {n: serving_batch(cfg, n, seq_len, region_len, n)
               for n in (256, 1024)}

    def same(tag, live_fn, art_fn, batch, want):
        with torch.no_grad():
            reset_launches()
            ref = live_fn(batch)
            torch.cuda.synchronize()
            n_live = dict(LAUNCHES)
            reset_launches()
            got = art_fn(batch)
            torch.cuda.synchronize()
            n_art = dict(LAUNCHES)
        equal = torch.equal(got, ref)
        print(f"artifact vs live ({tag}, b{batch[0].shape[0]}): logits "
              f"bit-equal {equal}, launches {n_art} vs {n_live}", flush=True)
        if not equal or n_art != n_live or n_live != expect(**want):
            raise RuntimeError(f"{tag}: the artifact's logits or launches "
                               "differ from the live forward's")
        return ref

    for n, batch in batches.items():
        same("kernels", live, art, batch, {"attention_fwd": 12})
    with torch.no_grad():
        names = [port_kernel_names(lambda: fn(batches[256]))
                 for fn in (live, art)]
    print(f"profiler, b256 (kernels): {len(names[1])} port kernels a call "
          f"of the artifact, {len(names[0])} of the live forward", flush=True)
    if names[0] != names[1] or not names[0]:
        raise RuntimeError("the profiler's kernels of the artifact differ "
                           "from the live forward's")

    # pairs/s at b1024, the live forward and the loaded artifact in turns
    runs = {"live": [], "artifact": []}
    b1024 = batches[1024]
    with torch.no_grad():
        for name, _ in ab_turns("live", None, "artifact", None):
            fn = live if name == "live" else art
            runs[name].append(1024 / (cuda_ms(lambda: fn(b1024), iters=5,
                                              warmup=1) / 1e3))
    for name, rs in runs.items():
        stats[f"{name}_pairs_s"] = float(np.median(rs))
        print(f"eval forward b1024 {name}: median "
              f"{stats[f'{name}_pairs_s']:.1f} pairs/s (runs "
              f"{', '.join(f'{r:.1f}' for r in rs)}) [{power}]", flush=True)
    # one call's host time through the registered op and the eager wrapper
    q, k, v, bias = attention_inputs(256, 60, 60, 12, 64, torch.bfloat16, 0)
    stats["op_us"] = host_us(lambda: torch.ops.volta.attention_fwd(
        q, k, v, bias, 0.125, 12))
    stats["wrapper_us"] = host_us(lambda: attention_cuda.attention_fwd(
        q, k, v, bias, 0.125, 12))
    print(f"host µs a call of row 1 at b256: registered op "
          f"{stats['op_us']:.1f}, eager wrapper {stats['wrapper_us']:.1f} "
          f"[{power}]", flush=True)

    # both LayerNorm flags: rows 1 and 10 as phase 10 counts them
    ln = export_cli(root, yml, flagged, "ln_kernels", "--use_pallas")
    ln_model, ln_back = ln["model"], ln["loaded"]
    same("LayerNorm flags",
         lambda b: ln_model(b[0], b[1], b[2], "TASK1", *b[3:]),
         lambda b: ln_back.call(ln["params"], *b), batches[256],
         {"attention_fwd": 12, "layer_norm_fwd": 29})
    del ln_model, ln_back, ln

    # int8: the live forward is apply_quantized with the same bundle
    q8 = export_cli(root, yml, CONFIG, "int8", "--use_pallas", "--quantize",
                    "int8")
    # the VQA model's Dense layers, each run once a forward (the
    # retrieval model of phase 20 has 77)
    n_dense = len(pint8.dense_modules(q8["model"]))
    if n_dense != 78:
        raise RuntimeError(f"{n_dense} Dense layers, expected 78")
    served = pint8.quantize_model(copy.deepcopy(q8["model"]), q8["params"])
    q8_back = q8["loaded"]
    same("int8", lambda b: served(b[0], b[1], b[2], "TASK1", *b[3:]),
         lambda b: q8_back.call(q8["params"], *b), batches[256],
         {"attention_fwd": 12, "int8_quantize": n_dense,
          "int8_matmul": n_dense})
    del served, q8_back, q8

    # the portable artifact: aten ops only, held as phase 9 holds the twins
    port = export_cli(root, yml, CONFIG, "portable")
    port_back = port["loaded"]
    b256 = batches[256]
    with torch.no_grad():
        kern = live(b256).float()
        with twins():
            plain = live(b256).float()
            with float64_attention():
                noise = float((plain - live(b256).float()).abs().max())
        reset_launches()
        got = port_back.call(port["params"], *b256).float()
        torch.cuda.synchronize()
    launched = sum(LAUNCHES.values())
    diff = float((got - kern).abs().max())
    tol = max(LOGIT_TOL, NOISE_FACTOR * noise)
    print(f"portable artifact on the card (b256): {launched} port kernels "
          f"launched, logits vs the kernel forward max abs diff {diff:.3e} "
          f"(tol {tol:.3e}, noise {noise:.3e})", flush=True)
    if launched or not diff <= tol or not bool(torch.isfinite(got).all()):
        raise RuntimeError("the portable artifact launched a kernel of the "
                           "port or strays from the kernel forward")
    stats["noise"] = noise
    del port_back, port

    baked = export_cli(root, yml, CONFIG, "baked", "--use_pallas",
                       "--bake_weights", check=False)
    stats["baked_mib"], stats["params_mib"] = baked["mib"], res["mib"]
    print(f"baked artifact: {baked['mib']:.1f} MiB on disk (parameterized "
          f"{res['mib']:.2f} MiB)", flush=True)
    os.remove(baked["path"])
    return stats


def trace_kernels_by_step(events, words):
    """The kernel events of a Chrome trace whose names hold one of
    ``words``, counted by the step range (``step_<n>``) whose span holds
    the host's launch of each (matched by CUPTI's correlation id), or
    under None where no launch event or step matches."""
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    steps = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("step_")]
    counts = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        word = next((w for w in words if w in e["name"]), None)
        if word is None:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        step = next((n for a, b, n in steps
                     if ts is not None and a <= ts <= b), None)
        counts.setdefault(step, {}).setdefault(word, 0)
        counts[step][word] += 1
    return counts


def check_profile_steps(root, data_dir, yml, power, attempts=3):
    """Phase 21 (b): ``train_task --profile_steps 3`` at 4 layers
    (``uniter_cut``) on synthetic VQA at b48 (one epoch, 25 steps, no val
    loop): the run's launches those of its plan, the trace file in
    ``<logdir>/<run>/``, the ranges of steps 20, 21 and 22 and of no
    other, and its kernel events: rows 3 and 4 and K10 as often as the
    plan launches them, 3 steps' worth, printed by step. The profiler at
    times records fewer kernels than ran (PERF.md section 7): a run whose
    kernel events fall short is run again, up to ``attempts`` runs."""
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    config, counts = uniter_cut(root)
    with open(yml) as f:
        text = f.read()
    b48 = os.path.join(root, "tasks_b48.yml")
    with open(b48, "w") as f:
        f.write(text.replace("  batch_size: 256", "  batch_size: 48"))
    argv = train_argv(root, data_dir, b48, config, 1, "profiled") + [
        "--eval_period", "9", "--profile_steps", "3"]
    attn, sites = counts["attn"], counts["k10"]
    per_step = {"attention_dropout_fwd": attn, "attention_dropout_bwd": attn,
                "hash_dropout_kernel": 2 * sites}
    for attempt in range(attempts):
        reset_launches()
        t0 = time.time()
        out = train_task.main(argv + ["--save_name", f"try{attempt}"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        steps, launches = out["steps"], dict(LAUNCHES)
        path = out["profile_trace"]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        want = expect(attention_dropout_fwd=attn * steps,
                      attention_dropout_bwd=attn * steps,
                      **k10(sites * steps))
        ranges = sorted(e["name"] for e in events
                        if e.get("cat") == "user_annotation"
                        and e["name"].startswith("step_"))
        by_step = trace_kernels_by_step(events, tuple(per_step))
        seen = {w: sum(c.get(w, 0) for c in by_step.values())
                for w in per_step}
        print(f"train_task --profile_steps 3 ({steps} steps at b48, 4 "
              f"layers, {wall:.1f} s, run {attempt + 1}): trace "
              f"{os.path.basename(path)} "
              f"({os.path.getsize(path) / 2**20:.1f} MiB), step ranges "
              f"{ranges}, kernel events {seen} over 3 steps (by step "
              f"{by_step}; the plan {per_step} a step), launches "
              f"{launches} [{power}]", flush=True)
        if os.path.dirname(path) != out["log_dir"] or steps < 23:
            raise RuntimeError(f"trace at {path}, {steps} steps")
        if ranges != ["step_20", "step_21", "step_22"]:
            raise RuntimeError(f"the trace covers {ranges}")
        if launches != want:
            raise RuntimeError(f"launches {launches}, expected {want}")
        if seen == {w: 3 * c for w, c in per_step.items()}:
            return attempt + 1
    raise RuntimeError(f"the trace's kernel events differ from the plan's "
                       f"in {attempts} runs")


def check_scan(task_cfg, batch, power):
    """Phase 21 (c): ``use_scan`` at ctrl_uniter_base's full width, bf16,
    the weights of the loop model: eval logits at b256 held to the loop
    route's as phase 9 holds the kernels to the twins; a b256 training
    step with the config's dropout, finite, with rows 3 and 4 12 times
    each and K10 only at the embeddings and the pooled output (the tails
    take the scan's Bernoulli draws), nothing else."""
    import torch

    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.models.layers import init_weights
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    cfg = VoltaConfig.from_json_file(CONFIG)
    cfg.compute_dtype = "bfloat16"
    models = {}
    for scan in (False, True):
        c = VoltaConfig.from_dict(dict(cfg.to_dict(), use_scan=scan))
        m = VoltaForVLTasks(c, task_cfg, ("TASK1",))
        init_weights(m, torch.Generator().manual_seed(0))
        models[scan] = m.cuda().eval()
    if not models[True].bert.encoder.scan or models[False].bert.encoder.scan:
        raise RuntimeError("use_scan did not pick the scan route")
    one = to_device(batch, "cuda")
    loop_step = make_task_eval_step(models[False], task_cfg, "TASK1")
    scan_step = make_task_eval_step(models[True], task_cfg, "TASK1")
    loop = loop_step(one)["prediction"].float()
    reset_launches()
    scanned = scan_step(one)["prediction"].float()
    eval_launches = dict(LAUNCHES)
    with twins():
        plain = loop_step(one)["prediction"].float()
        with float64_attention():
            noise = float((plain - loop_step(one)["prediction"].float())
                          .abs().max())
    diff = float((scanned - loop).abs().max())
    tol = max(LOGIT_TOL, NOISE_FACTOR * noise)
    print(f"use_scan eval b256: logits vs the loop route max abs diff "
          f"{diff:.3e} (tol {tol:.3e}, noise {noise:.3e}), launches "
          f"{eval_launches}", flush=True)
    if not diff <= tol or eval_launches != expect(attention_fwd=12):
        raise RuntimeError("the scan route's eval strays from the loop's")

    model = models[True].train()
    opt = build_optimizer("adamw", 1e-4, model, weight_decay=0.01,
                          clip_norm=1.0)
    state = create_train_state(model, opt, seed=1)
    step = make_task_train_step(model, opt, task_cfg, "TASK1")
    reset_launches()
    out = step(state, batch)
    loss = float(out["loss"])
    launches = dict(LAUNCHES)
    want = expect(attention_dropout_fwd=12, attention_dropout_bwd=12,
                  **k10(K10_FLAGGED))
    ms = cuda_ms(lambda: step(state, batch), iters=3, warmup=1)
    print(f"use_scan train step b256: loss {loss:.4f}, {ms:.2f} ms/step, "
          f"launches {launches} [{power}]", flush=True)
    if not np.isfinite(loss) or launches != want:
        raise RuntimeError(f"scan step launches {launches}, expected {want}")
    return {"scan_step_ms": ms, "scan_noise": noise}


# phase 22: data parallelism over torch.distributed
DP_STEPS = 3
# the losses of W ranks against the one-process step over their
# concatenated batch on the same card: the masks are equal (the folded
# seeds), so only the rounding of products at another M differs. fp32:
# float32 sums in another order, 1e-4 relative. bf16: phase 13 holds the
# b256 bf16 gradients of two summation orders within GRAD_TOL (5e-2,
# relative L2) of each other; the losses after DP_STEPS updates from such
# gradients are held to the same bound
DP_LOSS_TOL = {"float32": 1e-4, "bfloat16": GRAD_TOL}
DP_NCE_BATCH = 64


def dp_launches(case, counts, steps):
    """A data-parallel rank's launches of ``steps`` steps of ``case``: the
    default route's, the LayerNorm flags' (rows 9 and 14 at 0 though their
    flags are on: their gates close across ranks) or an NCE step's."""
    attn, tails = counts["attn"], counts["tails"]
    if case == "nce":
        return pretrain_launches(counts, steps, nce=1)
    common = dict(attention_dropout_fwd=attn * steps,
                  attention_dropout_bwd=attn * steps)
    if case == "flags":
        return expect(layer_norm_fwd=5 * steps, layer_norm_bwd=5 * steps,
                      dropout_residual_ln_fwd=tails * steps,
                      dropout_residual_ln_bwd=tails * steps,
                      **k10(K10_FLAGGED * steps), **common)
    return expect(**k10(counts["k10"] * steps), **common)


def dp_run(case, config, dtype, yml, batch_np, steps):
    """``steps`` steps of one phase 22 case on this process's card (a rank
    of the installed process group, or one process): a fresh model from
    seed 0 (every rank's, and rank 0's broadcast), clip + AdamW, the step
    seed from seed 11. Returns (the losses, the launches, the model, the
    wall ms a step)."""
    import torch

    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.parallel import broadcast_state
    from volta_tpu_torch.task_utils import load_task_config
    from volta_tpu_torch.train_step import create_train_state, \
        make_pretrain_step, make_task_train_step

    task_cfg = load_task_config(yml)
    if case == "nce":
        cfg = VoltaConfig.from_json_file(config)
        model = pretrain_model(cfg, dtype).train()
        opt = build_optimizer("adamw", 1e-4, model, clip_norm=5.0)
        step = make_pretrain_step(model, opt, cfg, objective=1)
    else:
        model = build_model(task_cfg, dtype, config=config).train()
        opt = build_optimizer("adamw", 1e-4, model, clip_norm=1.0)
        step = make_task_train_step(model, opt, task_cfg, "TASK1")
    state = create_train_state(model, opt, seed=11)
    broadcast_state(state)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    losses = [float(step(state, batch_np)["loss"]) for _ in range(steps)]
    torch.cuda.synchronize()
    return losses, dict(LAUNCHES), model, (time.time() - t0) / steps * 1e3


def params_equal_across_ranks(model, backend):
    """Whether every rank holds ``model``'s parameters to the bit: the
    elementwise max and min of their 32-bit patterns over the ranks
    agree."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1).view(torch.int32)
                      for p in model.parameters()])
    if backend == "gloo":
        flat = flat.cpu()
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def dp_worker(argv):
    """``chip_smoke.py --dp-worker <spec.json> <rank> <world> <store>
    <out.json>``: one rank of phase 22 (b) or (c), on the card the spec
    names for it, in a group of the spec's backend joined through the
    file store; each case's losses, launches and whether the ranks end
    equal to the bit, into <out.json>."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    spec_path, rank, world, store, out_path = argv
    rank, world = int(rank), int(world)
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(spec["devices"][rank])
    dist.init_process_group(spec["backend"], init_method=f"file://{store}",
                            rank=rank, world_size=world)
    out = {}
    try:
        for case in spec["cases"]:
            half = dict(np.load(f"{case['batch']}_{rank}.npz"))
            losses, launches, model, ms = dp_run(
                case["case"], case["config"], case["dtype"], spec["yml"],
                half, case["steps"])
            out[case["name"]] = {"losses": losses, "launches": launches,
                                 "ms": ms, "equal": params_equal_across_ranks(
                                     model, spec["backend"])}
            del model
            torch.cuda.empty_cache()
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0]
                                in ("volta_tpu", "jax", "jaxlib", "flax"))
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def spawn_ranks(root, tag, spec, world):
    """``world`` ``--dp-worker`` processes of ``spec``; the Popen objects
    and their output paths."""
    d = os.path.join(root, tag)
    os.makedirs(d, exist_ok=True)
    spec_path = os.path.join(d, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", spec_path,
         str(r), str(world), os.path.join(d, "store"), outs[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, outs


def wait_all(procs, what, timeout=600):
    """Wait for every process; raise with the output of one that failed.
    Every process is ended on the way out."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"{what} exited {p.returncode}:\n"
                               f"{log[-4000:]}")
    return logs


def dp_cases(root, yml, batch_np, cc_dir):
    """Phase 22 (b)'s cases at 4 layers (``uniter_cut``): the default
    route in bf16 and in fp32, the LayerNorm and both mask flags in bf16
    (rows 9 and 14 gated off across ranks), each DP_STEPS steps of the b256
    VQA batch, and one NCE pretraining step (``visual_target_weights
    {"2": 1}``) of a b64 Conceptual Captions batch whose halves differ in
    masked tokens and regions. Writes each case's halves (``<batch>_<r>
    .npz``); returns (cases, {name: the global batch}, {name: counts})."""
    from volta_tpu_torch.config import VoltaConfig

    base, counts = uniter_cut(root)
    flags, _ = uniter_cut(root, write_config(
        root, "ctrl_uniter_base_dp_flags.json", use_pallas_layernorm=True,
        use_fused_residual_ln=True, fuse_hidden_dropout=True,
        use_pallas_dropout_mask=True))
    nce_cfg, nce_counts = uniter_cut(root, write_config(
        root, "ctrl_uniter_base_dp_nce.json",
        visual_target_weights={"2": 1.0}))
    task_np = {k: v for k, v in batch_np.items()
               if isinstance(v, np.ndarray) and v.dtype.kind in "biuf"}
    ds = cc_dataset(cc_dir, "bfloat16",
                    VoltaConfig.from_json_file(nce_cfg).num_locs)
    ds.add_global_imgfeat = VoltaConfig.from_json_file(
        nce_cfg).add_global_imgfeat
    nce_np = {k: v for k, v in ds.get_batch(np.arange(DP_NCE_BATCH)).items()
              if isinstance(v, np.ndarray) and v.dtype.kind in "biuf"}
    halves = [{k: v[r * DP_NCE_BATCH // 2:(r + 1) * DP_NCE_BATCH // 2]
               for k, v in nce_np.items()} for r in range(2)]
    masked = [(int(((h["lm_label_ids"] != -1)
                    & (h["is_match"] == 0)[:, None]).sum()),
               int(((h["image_label"] == 1)
                    & (h["is_match"] == 0)[:, None]).sum())) for h in halves]
    print(f"NCE b{DP_NCE_BATCH} halves' masked (tokens, regions) under "
          f"objective 1: {masked}", flush=True)
    if masked[0][0] == masked[1][0] or masked[0][1] == masked[1][1]:
        raise RuntimeError(f"the NCE halves' masked counts agree: {masked}")
    batches = {"task": task_np, "nce": nce_np}
    for name, full in batches.items():
        n = len(next(iter(full.values())))
        for r in range(2):
            np.savez(os.path.join(root, f"dp_{name}_{r}.npz"),
                     **{k: v[r * n // 2:(r + 1) * n // 2]
                        for k, v in full.items()})
    cases = [
        {"name": "default bf16", "case": "default", "config": base,
         "dtype": "bfloat16", "steps": DP_STEPS, "data": "task"},
        {"name": "default fp32", "case": "default", "config": base,
         "dtype": "float32", "steps": DP_STEPS, "data": "task"},
        {"name": "LN and mask flags bf16", "case": "flags", "config": flags,
         "dtype": "bfloat16", "steps": DP_STEPS, "data": "task"},
        {"name": "NCE bf16", "case": "nce", "config": nce_cfg,
         "dtype": "bfloat16", "steps": 1, "data": "nce"}]
    for c in cases:
        c["batch"] = os.path.join(root, f"dp_{c['data']}")
    return cases, batches, {"task": counts, "nce": pretrain_counts(
        VoltaConfig.from_json_file(nce_cfg))}


def nccl_world1(store):
    """Join a process group of one rank over NCCL through a new file
    store."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method="file://" + store, rank=0,
                            world_size=1)


def dp_nccl_world1(root, yml, batch_np):
    """Phase 22 (a): the default b256 bf16 step with dropout, at 12
    layers, DP_STEPS steps in a process group of one rank over NCCL
    against the plain one-GPU step: losses and parameters equal to the
    bit, the plan's launches. Returns the two models (plain, group); the
    group is left."""
    import torch
    import torch.distributed as dist

    from volta_tpu_torch.config import VoltaConfig

    counts = plan_counts(VoltaConfig.from_json_file(CONFIG))
    plain_losses, _, plain, _ = dp_run("default", CONFIG, "bfloat16", yml,
                                       batch_np, DP_STEPS)
    nccl_world1(os.path.join(root, "dp_world1_check"))
    try:
        losses, launches, model, _ = dp_run("default", CONFIG, "bfloat16",
                                            yml, batch_np, DP_STEPS)
    finally:
        dist.destroy_process_group()
    want = dp_launches("default", counts, DP_STEPS)
    if launches != want:
        raise RuntimeError(f"NCCL world 1 launches {launches}, expected "
                           f"{want}")
    if losses != plain_losses:
        raise RuntimeError(f"NCCL world 1 losses {losses} vs the plain "
                           f"step's {plain_losses}")
    if not all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 plain.parameters())):
        raise RuntimeError("NCCL world 1 parameters differ from the plain "
                           "step's")
    print(f"NCCL world 1, b256 bf16 at 12 layers: {DP_STEPS} steps' losses "
          f"{losses} and every parameter equal to the plain step's to the "
          f"bit; launches the plan's", flush=True)
    return plain, model


def dp_world1_rates(root, yml, batch_np, plain, model, power):
    """Phase 22 (a), timed on an idle card in a new NCCL group of one: the
    plain step and the step in the group, ms in turns (plain, group,
    group, plain), and each step's device ms by family (the all-reduce's
    kernels in "NCCL collectives")."""
    import torch.distributed as dist

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.task_utils import load_task_config
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    task_cfg = load_task_config(yml)
    batch = to_device(batch_np, "cuda")
    steps = {}
    for name, m in (("plain", plain), ("group of one", model)):
        opt = build_optimizer("adamw", 1e-4, m, clip_norm=1.0)
        steps[name] = (create_train_state(m, opt, seed=11),
                       make_task_train_step(m, opt, task_cfg, "TASK1"))
    runs, dev = {"plain": [], "group of one": []}, {}

    def route(name):
        return dp_group_off() if name == "plain" else \
            contextlib.nullcontext()

    nccl_world1(os.path.join(root, "dp_world1_rates"))
    try:
        for name in ("plain", "group of one", "group of one", "plain"):
            state, step = steps[name]
            with route(name):
                runs[name].append(cuda_ms(lambda: step(state, batch),
                                          iters=5, warmup=1))
        for name in ("plain", "group of one"):
            state, step = steps[name]
            with route(name):
                dev[name] = profile_device(lambda: step(state, batch),
                                           float(np.median(runs[name])),
                                           f"b256 step, {name}", calls=2,
                                           top=6)
    finally:
        dist.destroy_process_group()
    out = {"plain_ms": float(np.median(runs["plain"])),
           "group_ms": float(np.median(runs["group of one"])),
           "plain_device_ms": dev["plain"],
           "group_device_ms": dev["group of one"]}
    print(f"b256 bf16 step at 12 layers [{power}]: plain "
          f"{out['plain_ms']:.2f} ms/step, device {out['plain_device_ms']:.3f}"
          f" ms; NCCL group of one {out['group_ms']:.2f} ms/step, device "
          f"{out['group_device_ms']:.3f} ms (turns {runs})", flush=True)
    return out


@contextlib.contextmanager
def dp_group_off():
    """The port's steps as without a process group while one is up: its
    ``active()`` false for the block."""
    from volta_tpu_torch.parallel import mesh

    real = mesh.active
    mesh.active = lambda: False
    try:
        yield
    finally:
        mesh.active = real


def dp_check_ranks(what, cases, outs, refs, counts, world, power):
    """Each rank's losses, launches and equality to the bit across ranks
    against the one-process references."""
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    if any(r["modules"] for r in ranks):
        raise RuntimeError(f"{what}: a rank imported {ranks[0]['modules']}")
    for c in cases:
        name = c["name"]
        want = dp_launches(c["case"], counts[c["data"]], c["steps"])
        ref = refs[name]
        for r, got in enumerate(ranks):
            got = got[name]
            if got["launches"] != want:
                raise RuntimeError(f"{what} {name} rank {r} launches "
                                   f"{got['launches']}, expected {want}")
            if not got["equal"]:
                raise RuntimeError(f"{what} {name}: the ranks' parameters "
                                   "differ")
            if got["losses"] != ranks[0][name]["losses"]:
                raise RuntimeError(f"{what} {name}: rank {r}'s losses "
                                   f"{got['losses']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            ranks[0][name]["losses"], ref))
        tol = DP_LOSS_TOL[c["dtype"]]
        print(f"{what} {name}: {c['steps']} steps, losses "
              f"{ranks[0][name]['losses']} vs one process {ref}, largest "
              f"relative difference {rel:.3e} (limit {tol:g}); parameters "
              f"equal to the bit across the {world} ranks; launches the "
              f"plan's a rank; {ranks[0][name]['ms']:.1f} ms a step on "
              f"rank 0's host clock [{power}]", flush=True)
        if not np.all(np.isfinite(ref)) or rel > tol:
            raise RuntimeError(f"{what} {name}: relative difference {rel}")


def dp_torchrun(root, data_dir, yml):
    """Phase 22 (d), started: ``torchrun --standalone --nproc_per_node 1
    -m volta_tpu_torch.train_task --distributed`` at 4 layers for one
    epoch on NCCL. Returns (the process, its argv's tail)."""
    cut, _ = uniter_cut(root)
    argv = train_argv(root, data_dir, yml, cut, 1, "dp")
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "volta_tpu_torch.train_task",
         "--distributed"] + argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, cut


def dp_resume(root, data_dir, yml, cut, log):
    """Phase 22 (d), checked: the torchrun run's checkpoint (rank 0's) and
    VAL line, then a one-GPU run of two epochs that resumes it and takes
    the second with the plan's launches."""
    import shutil

    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    argv = train_argv(root, data_dir, yml, cut, 2, "dp")
    save = os.path.join(root, "save_dp")
    (run,) = os.listdir(save)
    saved = torch.load(os.path.join(save, run, "ckpt", "train_state.pt"),
                       map_location="cpu", weights_only=True)
    data = load_dataset(train_task.parse_args(argv),
                        VoltaConfig.from_json_file(cut),
                        load_task_config(yml), "1")
    n_train, n_val = len(data["train_loader"]), len(data["val_loader"])
    vals = [l for l in log.splitlines() if " VAL epoch 0 TASK1 " in l]
    if saved["step"] != n_train or len(vals) != 1:
        raise RuntimeError(f"torchrun run: step {saved['step']}, VAL lines "
                           f"{vals}\n{log[-3000:]}")
    counts = plan_counts(VoltaConfig.from_json_file(cut))
    reset_launches()
    summary = train_task.main(argv)
    torch.cuda.synchronize()
    want = expect(attention_dropout_fwd=counts["attn"] * n_train,
                  attention_dropout_bwd=counts["attn"] * n_train,
                  attention_fwd=counts["attn"] * n_val,
                  **k10(counts["k10"] * n_train))
    if summary["steps"] != 2 * n_train or dict(LAUNCHES) != want \
            or len(summary["val_scores"]) != 1:
        raise RuntimeError(f"the resumed run: {summary['steps']} steps, "
                           f"launches {dict(LAUNCHES)}, expected {want}")
    print(f"torchrun --nproc_per_node 1 train_task --distributed (NCCL, 4 "
          f"layers): one epoch, {n_train} steps, rank 0's checkpoint at step "
          f"{saved['step']}, {vals[0].strip()}; a one-GPU run resumed it "
          f"and took epoch 1 ({n_train} steps) with the plan's launches, "
          f"val score {summary['val_scores'][0]:.4f}", flush=True)
    shutil.rmtree(save)


def check_data_parallel(root, data_dir, yml, batch_np, power):
    """Phase 22: (b) two ranks on the one card over gloo (``dp_cases``,
    two ``--dp-worker`` processes) and (d) ``dp_torchrun`` start first;
    beside them this process runs (b)'s cases on the concatenated batches,
    (a) ``dp_nccl_world1`` and, once the torchrun run has ended and no
    group is up here, (d) ``dp_resume``; then (b)'s ranks are held to
    those runs, (a) is timed on the idle card (``dp_world1_rates``) and
    (c) the default bf16 case runs over NCCL, one card a rank, where the
    host has two cards."""
    import torch

    cases, batches, counts = dp_cases(root, yml, batch_np,
                                      os.path.join(root, "cc"))
    spec = {"backend": "gloo", "devices": ["cuda:0", "cuda:0"], "yml": yml,
            "cases": cases}
    procs, outs = spawn_ranks(root, "dp_gloo", spec, 2)
    run_proc, cut = dp_torchrun(root, data_dir, yml)
    try:
        refs = {}
        for c in cases:
            refs[c["name"]] = dp_run(c["case"], c["config"], c["dtype"], yml,
                                     batches[c["data"]], c["steps"])[0]
            torch.cuda.empty_cache()
        plain, model = dp_nccl_world1(root, yml, batch_np)
        log = wait_all([run_proc], "torchrun train_task --distributed")[0]
        dp_resume(root, data_dir, yml, cut, log)
        wait_all(procs, "two ranks over gloo")
    finally:
        for p in procs + [run_proc]:
            if p.poll() is None:
                p.kill()
                p.wait()
    dp_check_ranks("two ranks on one card over gloo", cases, outs, refs,
                   counts, 2, power)
    stats = dp_world1_rates(root, yml, batch_np, plain, model, power)
    del plain, model
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    if n >= 2:
        spec = {"backend": "nccl", "devices": ["cuda:0", "cuda:1"],
                "yml": yml, "cases": cases[:1]}
        procs, outs = spawn_ranks(root, "dp_nccl", spec, 2)
        wait_all(procs, "two ranks over NCCL")
        dp_check_ranks("two ranks, one card each, over NCCL", cases[:1],
                       outs, refs, counts, 2, power)
    else:
        print(f"NCCL across cards not run: this host has {n} card",
              flush=True)
    return stats


def main(argv):
    import torch

    if argv[:1] == ["--dp-worker"]:
        return dp_worker(argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from volta_tpu_torch.ops import _build, attention_cuda

    power = card_line()
    print(power, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()
    with phase("2 build"):
        _build.load()
        lib = str(_build.library_path())
        print(f"kernels built ({_build.library_path().name})", flush=True)
        keep = [v[3] for k, v in resource_report(lib).items()
                if "keep_mask_kernel" in k]
        if not keep:
            raise RuntimeError("no keep_mask_kernel in the built library")
        hash_int_count(lib, keep[0])

    results = {}
    with phase("3 kernel 1"):
        results["attention_fwd"] = check_kernel(attention_cuda)
    with phase("4 kernels 2-4"):
        results.update(check_train_kernels())
    with phase("5 kernels 5-8"):
        results.update(check_head_major_kernels())
    with phase("6 kernels 10-13"):
        results.update(check_ln_kernels())
    with phase("7 kernels 9, 14 and K10"):
        results.update(check_mask_kernels())
    with phase("8 kernels 15 and 16, probes"):
        report, probe_launches = check_matmul_kernels()
        results.update(report)
    with tempfile.TemporaryDirectory() as root:
        with phase("dataroot"):
            data_dir, yml = make_dataroot(root)
        flagged = write_config(root, "ctrl_uniter_base_ln_kernels.json",
                               use_pallas_layernorm=True,
                               use_fused_residual_ln=True)
        hm = write_config(root, "ctrl_uniter_base_head_major.json",
                          attn_natural_layout=False)
        fuse = write_config(root, "ctrl_uniter_base_hidden_masks.json",
                            fuse_hidden_dropout=True)
        pmask = write_config(root, "ctrl_uniter_base_keep_mask.json",
                             use_pallas_dropout_mask=True)
        free = write_config(root, "ctrl_uniter_base_dropout_free.json",
                            attention_probs_dropout_prob=0.0,
                            hidden_dropout_prob=0.0)
        hm_free = write_config(
            root, "ctrl_uniter_base_head_major_dropout_free.json",
            attn_natural_layout=False, attention_probs_dropout_prob=0.0,
            hidden_dropout_prob=0.0)
        masks_ln = write_config(
            root, "ctrl_uniter_base_masks_ln_kernels.json",
            fuse_hidden_dropout=True, use_pallas_dropout_mask=True,
            use_pallas_layernorm=True, use_fused_residual_ln=True)
        with phase("9 eval slice"):
            _, base_rates = run_slice(
                root, data_dir, yml, power, CONFIG, "base",
                {"attention_fwd": 12},
                lambda m: (("kernels", contextlib.nullcontext),
                           ("twins", twins)),
                profile="--profile" in argv)
        with phase("10 eval slice, LN kernels"):
            _, eval_rates = run_slice(
                root, data_dir, yml, power, flagged, "ln_kernels",
                {"attention_fwd": 12, "layer_norm_fwd": 29},
                lambda m: (("LN kernels on", contextlib.nullcontext),
                           ("LN kernels off", lambda: ln_kernels_off(m))),
                ln_flags=True, profile="--profile" in argv)
        with phase("11 eval slice, head-major"):
            _, hm_rates = run_slice(
                root, data_dir, yml, power, hm, "head_major",
                {"attention_head_major_fwd": 12},
                lambda m: (("head-major", contextlib.nullcontext),
                           ("natural", lambda: natural_layout(m))),
                layout_check=True)
        with phase("12 train slice"):
            launches, data = run_train(root, data_dir, yml, flagged, hm,
                                       fuse, pmask, free, hm_free)
        from volta_tpu_torch.task_utils import load_task_config

        task_cfg = load_task_config(yml)
        batch = next(iter(data["train_loader"]))
        with phase("13 fp32 steps, bf16 gradients"):
            compare_steps(task_cfg, batch, flagged, hm, fuse, pmask,
                          masks_ln)
            compare_bf16_grads(task_cfg, batch, hm, fuse)
        with phase("14 train throughput"):
            rates = train_throughput(task_cfg, batch, power,
                                     "--profile" in argv, flagged, hm,
                                     hm_free, fuse, pmask)
        with phase("15 remat_ff, int threshold, checkpoints"):
            rates.update(check_remat_int_checkpoints(
                root, data_dir, yml, task_cfg, batch, power,
                "--profile" in argv, flagged, pmask))
        with phase("16 task heads"):
            check_task_kernels()
            task_yml = make_task_dataroot(root, data_dir)
            heads = uniter_cut(root)[0]
            task_runs = {tag: run_task(root, data_dir, task_yml, power,
                                       task, tag, cli, config=heads)
                         for task, tag, cli in (("12", "NLVR2", True),
                                                ("10", "refcoco+", True),
                                                ("8", "RetrievalFlickr30k",
                                                 False))}
        with phase("17 capture, plain route, train CLI extras"):
            rates.update(check_capture_train_extras(
                root, data_dir, yml, task_yml, task_cfg, batch, power,
                free, "--profile" in argv))
        with phase("18 the other families"):
            family_launches, family_rates = check_families(root, data_dir,
                                                           power)
        with phase("19 pretraining"):
            k8, pretrain_runs = check_pretraining(root, data_dir, yml, power,
                                                  "--profile" in argv)
            results.update(k8)
        with phase("20 retrieval CLI and K9, the other optimizers"):
            ret_yml, ret_vocab = retrieval_dataroot(root)
            ret_runs = run_retrieval(root, ret_yml, ret_vocab, os.path.join(
                root, "pretrain.bin"), power)
            results.update(check_k9(power))
            radam_on_card()
            optimizer_cli(root, data_dir, yml, heads)
            opt_rates = optimizer_rates(task_cfg, batch, power)
            skip_disconnected_lxmert(root, data_dir)
            trunk_lr_scale(root, os.path.join(root, "cc"), heads)
        with phase("21 export, profile_steps, use_scan"):
            export_stats = check_export(root, yml, power, flagged)
            export_stats["profile_runs"] = check_profile_steps(
                root, data_dir, yml, power)
            export_stats.update(check_scan(task_cfg, batch, power))
        with phase("22 data parallel"):
            dp_stats = check_data_parallel(root, data_dir, yml, batch, power)
    print(f"eval forward, kernels vs twins [{power}]: b256 "
          f"{base_rates[(256, 'kernels')]:.1f} vs "
          f"{base_rates[(256, 'twins')]:.1f}, b1024 "
          f"{base_rates[(1024, 'kernels')]:.1f} vs "
          f"{base_rates[(1024, 'twins')]:.1f} pairs/s", flush=True)
    print(f"LN kernels on vs off [{power}]: eval b256 "
          f"{eval_rates[(256, 'LN kernels on')]:.1f} vs "
          f"{eval_rates[(256, 'LN kernels off')]:.1f}, b1024 "
          f"{eval_rates[(1024, 'LN kernels on')]:.1f} vs "
          f"{eval_rates[(1024, 'LN kernels off')]:.1f}, train b256 "
          f"{rates['LN kernels on'][0]:.1f} vs "
          f"{rates['LN kernels off'][0]:.1f} pairs/s", flush=True)
    print(f"head-major vs natural layout [{power}]: eval b256 "
          f"{hm_rates[(256, 'head-major')]:.1f} vs "
          f"{hm_rates[(256, 'natural')]:.1f}, b1024 "
          f"{hm_rates[(1024, 'head-major')]:.1f} vs "
          f"{hm_rates[(1024, 'natural')]:.1f}, train b256 "
          f"{rates['head-major'][0]:.1f} vs {rates['natural'][0]:.1f} "
          "pairs/s", flush=True)
    print(f"dropout-free train step b256 [{power}]: natural "
          f"{rates['natural dropout-free'][0]:.1f} pairs/s "
          f"({rates['natural dropout-free'][1]:.2f} ms), head-major "
          f"{rates['head-major dropout-free'][0]:.1f} pairs/s "
          f"({rates['head-major dropout-free'][1]:.2f} ms)", flush=True)
    for flag in ("fuse_hidden_dropout", "use_pallas_dropout_mask"):
        print(f"{flag} on vs off [{power}]: train b256 "
              f"{rates[flag][0]:.1f} vs {rates[flag + ' off'][0]:.1f} "
              "pairs/s", flush=True)
    print(f"remat_ff vs plain [{power}]: train b256 default "
          f"{rates['remat_ff'][1]:.2f} vs {rates['plain'][1]:.2f} ms/step, "
          f"LN flags {rates['remat_ff LN flags'][1]:.2f} vs "
          f"{rates['plain LN flags'][1]:.2f} ms/step; int threshold vs hash "
          f"tails {rates['int threshold'][1]:.2f} vs "
          f"{rates['hash tails'][1]:.2f} ms/step", flush=True)
    print(f"plain route vs kernel route [{power}]: train b256 default "
          f"{rates['plain route'][1]:.2f} vs {rates['kernel route'][1]:.2f} "
          "ms/step", flush=True)
    for tag, r in [(t, run["rates"]) for t, run in task_runs.items()] + [
            ("ctrl_vilbert_base VQA", family_rates)]:
        print(f"{tag} [{power}]: eval {r['eval_items_per_s']:.1f} items/s, "
              f"train {r['train_ms']:.2f} ms/step", flush=True)
    print(f"retrieval CLI, 64 captions x 1000 images [{power}]: bf16 "
          f"{ret_runs['bf16']['pairs_per_s']:.1f}, zero-shot "
          f"{ret_runs['zero-shot']['pairs_per_s']:.1f}, int8 "
          f"{ret_runs['int8']['pairs_per_s']:.1f} pairs/s", flush=True)
    print(f"b256 train step [{power}]: " + ", ".join(
        f"{name} {ms:.2f} ms/step, peak {peak:.2f} GiB"
        for name, (ms, peak) in opt_rates.items()), flush=True)
    print(f"serving artifact, ctrl_uniter_base VQA bf16 [{power}]: export "
          f"{export_stats['export_s']:.2f} s, load "
          f"{export_stats['load_s']:.2f} s, parameterized "
          f"{export_stats['params_mib']:.2f} MiB, baked "
          f"{export_stats['baked_mib']:.1f} MiB; b1024 loaded artifact "
          f"{export_stats['artifact_pairs_s']:.1f} vs live "
          f"{export_stats['live_pairs_s']:.1f} pairs/s; row 1 host µs "
          f"registered op {export_stats['op_us']:.1f} vs wrapper "
          f"{export_stats['wrapper_us']:.1f}; --profile_steps trace "
          f"held in run {export_stats['profile_runs']}; use_scan train b256 "
          f"{export_stats['scan_step_ms']:.2f} ms/step", flush=True)
    print(f"b256 bf16 step at 12 layers, plain vs an NCCL group of one "
          f"[{power}]: {dp_stats['plain_ms']:.2f} vs "
          f"{dp_stats['group_ms']:.2f} ms/step, device "
          f"{dp_stats['plain_device_ms']:.3f} vs "
          f"{dp_stats['group_device_ms']:.3f} ms", flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s after the card check",
          flush=True)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("volta_tpu", "jax", "jaxlib", "flax"))
    if foreign:
        raise RuntimeError(f"the port imported {foreign[:5]}")
    # launches: rows 1-4 and K10 from the train runs without the LayerNorm
    # flags, rows 5-8 from the head-major runs, rows 10-13 from the flagged
    # run, rows 9 and 14 from the hidden-mask runs, rows 15-16 from the
    # probes
    counts = {**{k: launches["dropout"][k] for k in
                 ("attention_fwd", "attention_dropout_fwd",
                  "attention_dropout_bwd")},
              "attention_bwd": launches["dropout_free"]["attention_bwd"],
              **{k: launches["head_major"][k] for k in
                 ("attention_head_major_fwd",
                  "attention_dropout_head_major_fwd",
                  "attention_dropout_head_major_bwd")},
              "attention_head_major_bwd":
                  launches["head_major_dropout_free"][
                      "attention_head_major_bwd"],
              **{k: launches["flagged"][k] for k in
                 ("layer_norm_fwd", "layer_norm_bwd",
                  "dropout_residual_ln_fwd", "dropout_residual_ln_bwd")},
              "attention_dropout_hidden_masks_fwd": launches[
                  "hidden_masks"]["attention_dropout_hidden_masks_fwd"],
              "keep_mask": launches["keep_mask"]["keep_mask"],
              **{k: launches["dropout"][k] for k in k10(0)},
              **probe_launches, **pretrain_runs["nce"],
              # phase 20's int8 retrieval run
              **{k: ret_runs["int8"]["launches"][k]
                 for k in ("int8_quantize", "int8_matmul")}}
    # the body each attention kernel runs in bf16, as its wrapper routes it
    fwd, bwd = attention_cuda.fwd_body, attention_cuda.bwd_body
    bf16 = torch.bfloat16
    bodies = {"attention_fwd": fwd(bf16)[0],
              "attention_head_major_fwd": fwd(bf16)[0],
              "attention_dropout_fwd": fwd(bf16, dropout=True)[0],
              "attention_dropout_hidden_masks_fwd":
                  fwd(bf16, dropout=True)[0],
              "attention_dropout_head_major_fwd": fwd(bf16, dropout=True)[0],
              "attention_bwd": bwd(bf16)[0],
              "attention_head_major_bwd": bwd(bf16)[0],
              "attention_dropout_bwd": bwd(bf16, dropout=True)[0],
              "attention_dropout_head_major_bwd": bwd(bf16, dropout=True)[0]}
    rows = [{"name": name, "route": "cuda", "source": CSRC + src,
             "replaces": replaces, "launches": counts[name],
             "max_abs_err": results[name]["max_abs_err"],
             "ms": results[name]["ms"],
             "plain_ms": results[name]["plain_ms"],
             "bound_ms": results[name]["bound"][0],
             # the hash's integer term counts as "operations" here; the
             # phases' lines name it
             "bound_by": ("bytes" if results[name]["bound"][1] == "bytes"
                          else "operations"),
             "bound_share": results[name]["bound"][0] / results[name]["ms"],
             "library_ms": results[name]["library_ms"],
             **{k: results[name][k] for k in (
                 "shapes", "body", "leg2", "gather_ms",
                 "embedding_bag_ms") if k in results[name]},
             # phase 16's launches: the task heads' eval and train runs
             "task_heads_launches": sum(
                 run[k][name] for run in task_runs.values()
                 for k in ("eval", "train") if k in run),
             # phase 18's: every run of the other families
             "families_launches": sum(
                 runs[name] for family in family_launches.values()
                 for runs in family.values()),
             # phase 19's pretraining CLI run
             "pretrain_cli_launches": pretrain_runs["cli"][name],
             "pallas": name not in NOT_PALLAS,
             **({"body": bodies[name]} if name in bodies else {})}
            for name, (src, replaces) in KERNELS.items()]
    print(power, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
