#!/usr/bin/env python3
"""Chip smoke for mxtpu_torch: builds the port's CUDA kernels and drives its
main paths on one NVIDIA GPU: serving, training, the imperative ``nd`` +
``autograd`` path with runtime-compiled kernels (``rtc``), the Gluon front
end, the symbolic and Module front ends, the vision path (ResNet-50
training and the zoo's scoring), int8 quantization (an int8 ResNet-50,
the quantized fused training step), recurrent nets (the reference's
word LM, control flow, ``jit``), the data path (ResNet-50 trained from
a RecordIO file), detection (the SSD and Faster R-CNN toys, the
detection ops at SSD300's and Faster R-CNN's full sizes) and sparse
storage with ``linalg`` and the reference's binary format (the
factorization machine at Criteo width, a row-sparse word-LM embedding).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:

1. the card's name and power limit (``nvidia-smi``); build every kernel
   with ``nvcc`` (one process per source, in parallel); the compiler's
   registers, shared memory and spills per kernel; for the simt kernels
   (K1 to K4 on the CUDA cores) registers and spills per instantiation
   and no spill at DMAX 64 and 128 (DMAX 256's printed); for the sm90
   kernels (K1, and K2, K3 and K4 on the tensor cores) no spill, and
   ``wgmma`` (``HGMMA``) and TMA (``UTMALDG``) instructions in their
   machine code; for K5 no spill, and ``cp.async`` (``LDGSTS``) in its
   machine code;
2. K1 (flash-attention forward) against its plain PyTorch version on the
   card at the forward's shapes (B=4, H=12, T=1024, D=64, causal) in f32
   and bf16, at the training shape (B=8, H=16, T=1024, D=64, causal,
   bf16), plus ragged and wide-head shapes: error, kernel, plain and
   ``scaled_dot_product_attention`` times, and the bound; every bf16 case
   with D % 8 == 0 and D <= 128 must take the sm90 route, the rest the
   simt route;
3. K5 (dequant decode) against its plain version at the engine's decode
   shape (S=8, H=12, TOT=1024, D=64) with ragged cursors, int8 and fp8,
   twice (the same bits), at the one-position prefill shape (S=1, H=12,
   TOT=256 and 704, the last position), the "wide" preset's head (H=16,
   D=128), q in bf16, cursors past the bucket and D=40; the timed cases
   on a CUDA graph (the device alone), eagerly, and against the launch
   floor and the byte bound; then a cache and the same cache zero-padded
   into a larger bucket give the same bits under one ``span``, and so do
   the float-cache step's logits (``serving_step``, and ``int8_w`` over a
   float cache; TOT 256 -> 288 and 704 -> 1024); the ``xla`` read
   (``_decode_xla``, plain ops with exact int32 sums, no kernel) at the
   decode shape against its CPU result within 1e-5 x max(|CPU|, 1) and
   K5's plain version within the reference's bound, timed on a graph
   beside K5;
4. forward: ``transformer_lm("base", vocab_size=50257)`` (GPT-2 124M
   dimensions) scores a (4, 1024) batch; K1 must launch;
5. serving: ``ServingEngine(that model, slots=8, quant="int8_kv")`` answers
   8 greedy requests (prompts of 64-700 tokens, 128 new tokens each),
   then 8 more of the same lengths; every prefill and decode chunk runs as
   a replay of its captured CUDA graph, one capture per program key, none
   in the second burst; K5 must launch on every layer of every step, and
   its launch count must equal the replayed steps' and the captures'
   warm-up steps'; tokens/s, TTFT, captures and their time, peak memory;
   then two of the requests twice through one engine, the second time
   under ``torch.profiler`` with the tracer on, for the device's busy
   share while replaying, K5's launches and mean time per launch, and the
   engine's ``serving/*`` spans in the profiler's trace;
5b. int8 weight products (``quant.serve._int8_matmul``: row quantization,
   cuBLASLt int8 x int8 -> int32 through ``torch._int_mm``, rescale) at
   M in {1, 8, 40} x (768 -> 768, 768 -> 3072, 3072 -> 768, 768 ->
   50257): bit-equal to the exact sums, timed on a CUDA graph against
   ``F.linear`` in f32; whether ``F.linear`` over 40 flattened rows gives
   each 8-row block's bits (printed: the verify step's float products
   run at the decode step's shape because it does not);
5c. speculative serving on phase 5's model: ``ServingEngine(slots=8,
   quant="int8_kv,int8_w", spec=SpecConfig(k=4), prefix_cache_mb=64)``
   serves phase 5's lengths (the 333- and 480-token prompts share 256
   tokens, the 170-token request samples at temperature 0.8, top-k 40);
   the same burst without ``spec``; then the burst under
   ``quant="int8_kv"`` (f32 weights) and over a float cache
   (``quant=None``), each with and without ``spec``. Every request's
   tokens equal the spec-less engine's in all three legs; every prefill
   chunk, decode chunk and verify dispatch a replay, one capture per key,
   none in the profiled wave that follows the speculative burst; K5's
   launches exactly L x (prefill positions + decode chunks x 8 + 5 x
   verify dispatches + the captures' warm-up steps, 5 for a verify
   program; none over the float cache); a prefix-cache hit; tokens/s,
   TTFT, captures, accept
   lengths, drafted/accepted/rejected, n-gram hits, the drafter's host
   time and peak memory of each leg; then two requests through the
   speculative engine under ``torch.profiler``;
5e. the serving control plane on phase 5's model: a two-tenant trace of
   ``sched.replay`` (8 batch-tier requests of 400-700 tokens, 128 new,
   after a one-bucket pilot; then, once the first batched group decodes,
   8 interactive requests of 64-200 tokens, 64 new) through
   ``ServingEngine(slots=8, quant="int8_kv", sched=True, prefill_batch=4,
   stall_deadline_s=60, engine_id="e0")``: at least one preemption with
   park and resume and one batched prefill group of 2 or more; every
   request's tokens equal a plain ``ServingEngine(slots=8,
   quant="int8_kv")``'s; every B=1 and batched prefill chunk and decode
   chunk a replay, one capture a key; K5's launches exactly L x (batched
   and B=1 prefill positions + decode chunks x 8 + the warm-ups); the
   ``serving`` heartbeats at least the dispatches and no stall; one feed
   transfer a request; tokens/s, TTFT median and max, shed, preempted and
   resumed a tenant. Then three handoffs of phase 5c's first burst
   (``int8_kv``, a float cache, ``int8_kv`` with ``spec=4``): drained
   after a few decode turns with one request mid-prefill, adopted by a
   fresh engine; every request's tokens equal the undisturbed engine's
   (5c's spec-less legs), zero drops; drain and adopt ms, handoff bytes,
   the adopting engine's captures; the timeline of an adopted request
   (submit, admit, prefill, decode, drain, adopt, decode, retire, in
   order); K5 against its plain version at the batched prefill's shape
   (S 4, PB 704, every cursor last), timed on a graph;
5f. the router: ``Router.local`` over two engines of phase 5's model
   (``int8_kv``, slots 8, ``sched``) on the card, phase 5's 8 prompts and
   4 sharing a 32-token first block (their references from phase 5's
   engine), 128 new tokens each; once both replicas decode, the exporter
   is scraped once on port 0 (router counters, each engine's label,
   ``/json``), the busier replica is removed (its requests re-routed as
   continuations) and the survivor rebalanced (drain, a fresh engine,
   adopt) mid-flight. Every request equals its reference, zero drops;
   every chunk a replay on each of the three engines; K5's launches
   exactly L x (prefill positions + decode chunks x 8 + warm-ups) summed
   over them; wall time, tokens/s, the removal's and the rebalance's ms,
   each continuation's TTFT, each engine's stream and captures. Each
   continuation that held a decode slot on the removed replica must hold,
   on the survivor, that replica's K/V rows bit for bit (int8 codes and
   scales; the prompt's rows and the emitted tokens' apart; at least one
   with rows that decode wrote): the survivor prefills the prompt and
   replays the emitted tokens through its decode steps;
6. card against CPU: at base width with 2 layers, the same weights on the
   card and on the CPU give the same greedy tokens for 2 requests of 32
   new tokens (int8 and fp8 KV, a float cache, int8 weights over a float
   cache, int8 KV through the ``xla`` read), and forward logits that
   agree; then the
   serving programs at that size (int8 KV): a greedy and a sampled
   request through the prefill and decode programs (cursors in K5's
   chunk 0 of a split page), once by graph replays and once through the
   programs' bodies (a host sync there is an error): tokens equal, cache
   and page bit-equal, every chunk a replay, K5's launches exact;
6b. the verify step card against CPU: one verify dispatch of a base-width,
   2-layer ``int8_kv,int8_w`` model (S 8, TOT 832, k 4, one slot clipped
   at TOT - 1) by a replay of its captured program and on the CPU: tok,
   p, outs and lives equal, logits within ``VERIFY_LOGITS_TOL``; the int8
   codes of every row quantization (activations of each product, K/V rows
   appended) captured on both sides: the rows whose codes all agree
   within 1e-4, the others behind codes one step apart; each of
   the 10 K5 calls
   inside the replay against the plain version (clones captured beside
   them), and K5 timed at those calls' shapes;
7. K2, K3 and K4 (flash-attention backward) against the plain backward on
   the card at the training shape (B=8, H=16, T=1024, D=64, causal) in
   bf16 and f32, and at ragged shapes (T=1000, T != Tk, D=40, 128, 256),
   with an lse cotangent and with bf16 lse/Delta rows: kernel, plain and
   ``scaled_dot_product_attention``-backward times, and the bounds; K2,
   K3 and K4 take the sm90 route by K1's rule; K4's dq, dk and dv equal
   K2's and K3's bit for bit on both routes; then K2 + K3 timed against
   K4 on a small grid and without the causal mask;
8. training: ``transformer_lm("flagship", vocab_size=16384)`` in bf16
   (d1024, L8, H16) takes 1 + 24 Adam steps on one fixed (32, 1024) batch
   through ``DataParallelTrainer(micro_batches=4)``, whose step is one
   program: the first step runs its body on a side stream, the second
   captures it as a CUDA graph, every later step replays it (24 replays);
   the loss must fall by 0.3 (the learning gate of the JAX package's
   benchmark), ``data_parallel_step`` must show 1 trace and 24 hits, and
   K1, K2 and K3 must launch once per layer, micro-batch and step, replays
   counted, all three on the sm90 route; capture ms, ms/step over the
   replays, tokens/s, the bf16 FLOP share, peak memory and
   ``optimizer_state_bytes()``; ``cost_analysis()`` (counted on the
   first step) within 5% of the hand count, term by term; what the
   count adds to that first step (the body eagerly, alone and counted);
   then one replayed step under ``torch.profiler``;
8b. the training program against its body: from the same weights, 1 + 3
   steps through ``step_async`` (body, capture and replay, replays) and 1
   + 3 through ``eager_step`` (the body each step): losses, weights and
   optimizer states ``torch.equal``, for the bf16 flagship under Adam
   (sm90), base width, 2 layers, f32 with dropout 0.1 and ``remat=True``
   (simt; masks differ between steps) and the bf16 flagship under SGD
   with momentum, a ``FactorScheduler`` halving lr every step and
   ``clip_gradient``; then the multi-tensor update
   (``step_cache.build_update_all``) ``torch.equal`` to the per-tensor one
   (``build_update_all_plain``) on one step's gradients, in bf16 and f32,
   under Adam and SGD with momentum;
9. the fused backward: 3 steps of the same run with the split pair, then 3
   under ``MXTPU_FLASH_BWD=fused``, K4 on the sm90 route; then the same
   for phase 10's f32 model (base width, 2 layers), K4 on the simt route;
   in both the losses and the trained weights equal the split run's bit
   for bit (each run captures its program, so the knob is read at
   capture);
10. training card against CPU: base width, 2 layers, f32, B=4, T=256; the
    first batch's gradients, the losses of 3 Adam steps (captured on the
    card, the body on the CPU) and the weights after them agree; K1, K2
    and K3 take the simt route;
11. K6 checks (``rtc``: CUDA C compiled by NVRTC, launched through the
    driver API): saxpy and a gridded tile kernel against ``a*x + y`` and
    ``2*x`` on ``tests/test_rtc.py``'s numbers, a templated ``axpy<T>``
    through its exports, a kernel with 64 KB of dynamic shared memory,
    and five refusals (an undeclared export, a missing name, a dtype
    against the signature, a CPU array, source that does not compile);
    saxpy driven once and timed at 2^26 elements;
12. the imperative head: the flagship's output layer (x (8192, 1024) ->
    vocab 16384, f32) trained 10 steps through ``nd.dot``, a ``CustomOp``
    whose forward and backward launch two runtime-compiled softmax
    cross-entropy kernels, ``backward`` and ``W -= lr * W.grad``; the loss
    must fall by 0.3, each kernel launch 10 times, and losses and weights
    agree with the same steps through a plain ``CustomOp`` of ``nd`` ops;
    then the pair timed against its plain version, its bound and
    ``F.cross_entropy``;
13. Gluon: (a) ``transformer_lm("flagship", vocab_size=16384)`` through
    ``net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))``, ``net.cast(
    "bfloat16")`` and ``gluon.Trainer(net.collect_params(), "adam",
    {"learning_rate": 3e-4})`` memorises one batch (B=8, T=1024) in 12
    steps of ``autograd.record()``, forward, ``SoftmaxCrossEntropyLoss``,
    ``backward()``, ``trainer.step(8)``: the loss must fall by 0.3, K1,
    K2 and K3 launch 8 x 12 times each, all on the sm90 route, and the
    update's program is captured on step 1 and replayed on steps 2-12;
    the median ms a step of the last 10 and the peak memory beside phase
    8's captured ms for the same tokens; (b) at full width but 2 layers
    (f32, B=2, T=256) the card and the CPU load one ``.params`` file and
    take 3 Gluon steps under Adam, then 3 under ``RMSProp(centered=
    True)``: losses within 1e-5, weights within 5e-5 of each tensor's
    largest entry or 1, whichever is larger (phase 10's 5e-5); (c) (b)'s net in bf16 takes 3 Adam steps under
    ``multi_precision``: every bf16 weight is its f32 master cast, bit for
    bit; (d) ``save_parameters`` into a fresh net gives bit-equal
    parameters, and ``save_states`` into a fresh Trainer a next step
    bit-equal to the uninterrupted run's; (e) ``DataParallelTrainer``
    (micro_batches 1) takes (b)'s Gluon-built net: its first loss within
    1e-5 of the Gluon path's.
14. the symbolic and Module front ends: (a) ``Module(transformer_lm(
    "flagship", vocab_size=16384))``, ``init_params(mx.init.Xavier())``,
    ``cast("bfloat16")``, ``fit(NDArrayIter(one batch B=8, T=1024),
    optimizer="adam", learning_rate 3e-4, num_epoch=12)`` through the fused
    step (``step_cache.StepExecutor``): the loss must fall by 0.3,
    ``module_step`` 1 trace and 11 hits, one program captured once and
    replayed 11 times, K1, K2 and K3 96 launches each on sm90; ms a step
    (median of the last 10), capture ms and peak memory beside phases 13's
    and 8's; (d) ``predict(chain=4)`` over 9 batches of B=2 bit-equal to
    ``predict(chain=1)``, one program a key, K1 = 8 x 9 + the warm-ups;
    (f) ``save_checkpoint`` -> ``load_checkpoint`` into a new Module:
    bit-equal predictions; (b) at full width, 2 layers, f32, B=2, T=256,
    3 fused Adam steps on the card against the CPU and against the same
    steps eagerly (``engine.bulk(0)``) on the card: losses within 1e-5,
    weights within 5e-5 of each tensor's largest entry or 1 (bit-equality
    printed); (c) a graph built with ``mx.sym`` (Embedding,
    FullyConnected, ``contrib.flash_attention`` causal, FullyConnected,
    SoftmaxOutput; d1024 H16 V16384) ``simple_bind`` on the card in f32:
    one forward and backward at B=8, T=1024 launches K1, K2 and K3 once
    each (simt); ``tojson`` -> ``load_json`` -> a new bind gives the same
    bits; at B=1, T=256 outputs within 1e-5 and gradients within 5e-5 of
    each tensor's largest entry of the same executor on the CPU; a
    ``Module`` over the graph learns (> 0.3) in 10 eager steps, and its
    checkpoint through ``SymbolBlock.imports`` gives the same bits; (e)
    ``BucketingModule`` over one flagship weight set, buckets T=512 and
    T=1024 interleaved, 3 steps each: one captured program a bucket, one
    Trainer and one optimizer state a weight shared by both.

15. the vision path (the JAX package's headline workload, ``bench.py``'s
    ``bench_train`` and ``bench_inference``; no TPU kernel lies on it, the
    convolutions, pooling and BatchNorm are PyTorch's own ops): (a)
    ``resnet50_v1(classes=1000)``, its shapes deferred, through
    ``DataParallelTrainer`` with ``SGD(0.05, momentum 0.9, wd 1e-4)`` and
    softmax cross-entropy on one resident batch from seed 0, legs
    ``fp32_b32`` (f32 without TF32) and ``bf16_b128``, each 1 + 1 + 20
    steps with the step captured once: the loss must fall by 0.3; ms a
    step, img/s, capture ms, captures and replays, the device's busy share
    over 3 replays, peak memory and the FLOP share of the type's peak
    (``cost_analysis``); then one replayed step against the body run
    eagerly from the same state: bit-equal, or each tensor within 5e-5 of
    its largest entry with the ops whose gradients two identical passes
    do not reproduce named; (b) ``bf16_b512x4``: B=512 as 4
    micro-batches, the running statistics after the captured step equal
    an eager step's over the same micro-batches from the same state, 3
    replays timed, peak memory; (c) ``resnet18_v1`` (f32, B2, 64x64, 10
    classes) card against CPU: predict- and train-mode logits within 1e-3,
    one SGD-momentum step's loss within 1e-5 and weights and running
    statistics within 5e-5; (d) ``alexnet``, ``resnet50_v1``,
    ``mobilenet1.0`` and ``inceptionv3`` (299) f32 at B1 and B32, chained
    through ``ChainedPredictor`` (n = 50, 20) and per call after
    ``hybridize(static_alloc=True)``: img/s of both, outputs bit-equal or
    the differing layer named; (e) every other ``get_model`` name at B1 at
    its published size: output (1, 1000), finite, ms; (f) one profiled
    replay of ``bf16_b128``: busy share and its top device operations. K1
    to K5 must not launch in it.
16. int8 quantization (``ops/quantization.py``, ``contrib.quantization``,
    ``quant.calibrate``, ``quant.train``; no TPU kernel lies on it: the
    int8 products are ``torch._int_mm``, exact int32 sums, and a
    convolution is im2col of the codes times the weight codes through it):
    (a) ``bench.py``'s ``bench_int8`` body: 60 chained n = 8192 int8
    products (``// 1024`` back to int8) against the chain in bf16, TOP/s
    beside the dense peaks, one product equal to int64 arithmetic on a
    slice; (b) ``resnet50_v1(classes=1000)`` with phase 15 (d)'s weights
    (seed 0), ``quantize_net(quantized_dtype="auto",
    calib_mode="entropy")`` over 4 seeded B32 batches at 224, nothing
    excluded: the calibration seconds (histograms on the device, counts
    equal to ``np.histogram`` on one site's input), held-out B32 logits
    within the reference's ``0.1 x max(1, max|f32|)`` of the float net's,
    top-1 agreement; the int32 accumulators of the stem (uint8, K = 147),
    a strided 1x1, a 3x3 and the dense head, and of a strided 3x3 and a
    depthwise 3x3 (the tap loop) on random codes at a stage's shape, equal
    to int64 arithmetic; scoring at B1 (n = 20) and B32 (n = 10), chained
    through ``ChainedPredictor`` and per call, bit-equal, img/s beside
    phase 15 (d)'s f32 net; (c) ``resnet18_v1`` (B2, 64x64) quantized on
    the card and on the CPU from the same weights and calibration data
    (``int8``/``naive``, ``auto``/``entropy``): thresholds within one
    histogram bin, logits within ``QCARD_TOL``, differing activation
    codes counted, each one step; (d) phase 14 (a)'s ``Module.fit`` under
    ``MXTPU_QUANT_STEP=int8``: one capture then 11 replays, 48 staged
    quantized sites, K1-K3 96 launches each on sm90, the loss falls by 0.3
    and ends within 5e-2 relative of the float fit's from the same seed
    (run here); the first Dense site's output in the last replay
    bit-equal to int64 arithmetic of its int8 codes, rescaled; a flip to
    ``fp8`` and back builds one program and then hits; (e) card against
    CPU under the quantized step: the flagship at 2 layers (f32, B2 T256)
    3 SGD-momentum steps under ``int8`` and ``fp8``, and one ``int8`` step
    of a small conv net (``quant_conv``): losses, weights and the product
    of the card step's first quantized site of each kind (against the
    mode's product of the same operands on the CPU) within 5e-5 x
    max(largest entry, 1) (fp8's losses 2e-4: an e4m3 code that rounds
    the other way moves its value by 1/16 to 1/8 of itself); controls:
    the card's runs in the other mode and with the mode off fail that
    check against each CPU run.
17. recurrent nets, control flow and ``jit`` (``ops/{rnn,sequence,
    control_flow}.py``, ``gluon.rnn``, ``jit``, ``rnn``; no TPU kernel
    lies on it: the recurrence is a loop of plain PyTorch ops, captured
    with the step): (a) ``bench.py``'s ``bench_word_lm``:
    ``Embedding(10000, 650)`` -> ``LSTM(650, 2 layers, TNC)`` ->
    ``Dense(10000)`` inside its ``LMWrap`` ((N, T) -> (T, N) in the
    forward), T35 B128 f32, one resident batch from RandomState(0),
    SGD(1.0, momentum 0.9) through ``DataParallelTrainer``: 1 + 1 + 30
    steps, one capture, the learning gate (final loss < first - 0.1);
    ms a step, tokens/s, capture ms, peak memory, busy share of 3
    replays, FLOPs (3 x 118.8 G) against 67 TFLOP/s f32; one replayed
    step bit-equal to its body run eagerly from the same state; two
    replays from one state at t and t + 1 give the same loss; one LSTM
    layer at this shape, forward and backward, through ``rnn_scan`` and
    through ``torch.nn.LSTM`` (cuDNN, the same weights: a yardstick, not
    on the path); then the same net at ``dropout=0.5``: two replays from
    one state at t and t + 1 differ (new masks between the layers), at t
    twice they are equal; (b) card against CPU: a 2-layer LSTM LM (64
    wide, T8 B4) logits within 1e-5 x max(|CPU|, 1), its weights after
    one SGD-momentum step within 5e-5 of each tensor's largest entry; a
    bidirectional 2-layer GRU and ``rnn_tanh`` through the fused ``RNN``
    op, outputs and states within 1e-5; (c) ``examples/train_word_lm.py``'s
    flow (vocab 60, 48 wide, B8, bptt 16, lr 4, 4 epochs on its Markov
    corpus): a ``CachedOp`` over the window loss, eager under ``record``,
    ``clip_global_norm(0.25)``, ``gluon.Trainer`` SGD, validation through
    the ``CachedOp`` captured once and replayed (hits counted): best
    validation perplexity < 20; (d) ``foreach`` over an ``LSTMCell``
    against ``rnn_scan`` with its weights within 1e-6; ``while_loop``'s
    reference example and its gradient equal on card and CPU; ``cond``
    inside a ``CachedOp`` captured once: both predicates equal the eager
    branch; (e) ``BucketSentenceIter`` (buckets 4, 8, 12) into
    ``BucketingModule`` over an NTC LSTM: one epoch, one fused program a
    bucket, the masked cross-entropy falls. K1 to K5 must not launch in
    it.
18. the data path (``recordio``, ``native``, ``image``, ``io``,
    ``ops/image_ops.py``, ``gluon.data``; no TPU kernel lies on it: the
    reference decodes on the host and its image ops are ``jnp``): 384
    records packed from the committed fixture (``mxtpu_torch/fixtures/
    jpeg224``: 16 noise JPEGs, 224x224, image i % 16, label i % 10);
    the JPEG decode route (``image.DECODE_ROUTE``) printed; (a)
    ``bench.py``'s ``bench_train_e2e``: phase 15's ``bf16_b128`` trainer
    fed by ``ImageRecordIter(dtype="uint8", rand_mirror=True,
    preprocess_threads=nproc, prefetch_buffer=2, ctx=gpu(0))``, each uint8
    batch staged by its ``DeviceFeed`` and normalized on the card, 4
    epochs (1 warm step, 11 timed; the step captured once, every e2e step
    a replay, the losses finite): e2e img/s, host feed (the iterator
    alone), feed+transfer, the synthetic step on a resident batch through
    the same trainer, overlap efficiency, chip idle (1 - synthetic compute
    / wall), nproc; (b) each fixture JPEG decoded on the route to its
    libjpeg SHA-256 and mean error; one shuffled, mirrored epoch staged
    to the card on nproc threads bit-equal to the host path on one thread,
    seeded alike; the 8 ``nd.image`` ops card against CPU (1e-5 rel + 1e-6
    abs; resize 1e-4 abs, uint8 one step) and a p = 0.5 flip's frequency;
    (c) ``ImageRecordDataset`` through ``transforms.Compose([
    RandomFlipLeftRight, ToTensor, Normalize])`` and ``DataLoader(
    num_workers=nproc, ctx=gpu(0))`` scoring f32 ResNet-50 at B32: img/s,
    the feed's stall share; the first batch's logits bit-equal to the same
    batch fed from a resident tensor; (d) ``examples/train_mnist.py``'s
    flow: ``MNISTIter`` (synthetic) into ``Module.fit`` of LeNet, 3 epochs
    at B64, held-out accuracy > 0.9. K1 to K5 must not launch in it.
19. detection (``ops/{order,contrib_ops,detection,spatial}.py``,
    ``image/detection.py``; no TPU kernel lies on it: the reference's
    detection ops are ``jnp``/``lax``): (a) ``examples/train_ssd_toy.py``
    on the port's Gluon at its defaults (150 steps, B16, SGD lr 0.4,
    momentum 0.9): mean IoU of the top detections > 0.3; the first
    step's ``MultiBoxTarget`` equal to the CPU's on the same inputs
    (class targets and masks exact, box targets within 1e-6); the first 3
    losses within 1e-5 x max(|CPU|, 1) of a CPU run from the same
    weights; ms a step; (b) ``ImageDetIter`` (``rand_crop``,
    ``rand_mirror``) over a ``.rec`` of 64 toy PNGs packed in the phase
    (labels ``[2, 5, cls, x1, y1, x2, y2]``), staged to the card and fed
    to ``MultiBoxTarget``: batches bit-equal to the CPU path's under the
    same seed, every box within one pixel of its rectangle's extent, the
    targets card = CPU; (c) ``examples/train_rcnn_toy.py``'s graph through
    ``simple_bind`` (B8, 150 steps, lr 0.05, from the example's own
    initial weights): the last step's rpn_acc > 0.75, roi_acc > 0.5,
    pos_frac > 0.25; ``Proposal`` card against CPU;
    (d) full size, f32, each op eager: SSD300's detection layer (6 maps
    38-1, 8732 anchors, 21 classes, B32, labels padded to 50): the 3x3
    heads, ``MultiBoxPrior`` a map, ``MultiBoxTarget`` (mining ratio 3;
    also replayed on a CUDA graph, bit-equal), both losses and backward,
    ``MultiBoxDetection`` (NMS 0.45, top 400); Faster R-CNN's
    ``Proposal`` on (2, 18, 38, 63) (21546 anchors, 6000 -> 300) and
    ``ROIPooling`` of its rois on (2, 512, 38, 63), 7x7 at 1/16, forward
    and backward, peak memory < 2 GiB; each op's ms; (e) every op of the
    four op modules card against CPU at the CPU tests' shapes (outputs
    and gradients within 1e-5 rel + 1e-6 abs, ``ctc_loss`` 1e-4;
    indices, masks, keep sets and integers exact). In (c) and (d) a keep
    decision that differs between card and CPU must be a pair whose IoU
    lies within 1e-5 of the threshold (printed), and the rows after it
    are not compared. K1 to K5 must not launch in it.
20. sparse storage, ``linalg`` and the reference's binary format
    (``ndarray/{sparse,legacy_io}.py``, ``ops/linalg.py``,
    ``io.LibSVMIter``, the lazy row-sparse updates, the kvstore's sparse
    surface; no TPU kernel lies on it: the JAX package's sparse ops are
    ``segment_sum``s, its linalg ``jnp.linalg``): (a)
    ``examples/train_sparse_fm.py``'s flow at ``tests/test_examples.py``'s
    configuration (1200 rows, 5000 features, rank 8, nnz 20, batch 128,
    lr 0.5, 4 epochs), ``fm_train``: ``LibSVMIter`` -> ``sparse.dot`` ->
    three transposed dots (row-sparse gradients) -> ``kv.push`` into a
    ``local`` store with SGD's lazy update -> ``row_sparse_pull``, every
    step in ``nd`` ops on the card: final accuracy > 0.78; w and V after
    epoch 1 within 1e-5 x max(|CPU|, 1) of the CPU's; (b) the same flow
    at Criteo width (a LibSVM file written from a seed: 39 hashed fields
    a row over 1,000,000 features, each field uniform over its published
    cardinality, rank 16, batch 1000, 20 batches): ``LibSVMIter``'s
    rows/s, ms a batch (the first pass, the warm step, then dot, the
    transposed dots, push and ``row_sparse_pull`` synchronised), rows
    touched, peak memory; rows no batch touched bit-equal to their start;
    w and V within 1e-5 x max(|CPU|, 1) of the CPU's; (c) the word LM's
    net (``Embedding(10000, 650, sparse_grad=True)`` -> ``LSTM(650, 2
    layers)`` -> ``Dense(10000)``, f32, T35 B128) through
    ``gluon.Trainer("sgd", momentum=0.9)``, eager: the table's gradient
    row-sparse over exactly the batch's ids; step 1 equal to the
    ``sparse_grad=False`` net's within 1e-6 of each tensor's largest
    entry; after 3 steps the rows outside the batches keep their weight
    and a zero momentum bit for bit; one step card against CPU (loss
    1e-5, gradient ids exact, values 5e-5 of the largest entry); (d)
    the 20 ``linalg`` ops at (4, 64, 64) f32, card against CPU (outputs
    and the gradients of a sign-invariant loss within 1e-4 x max(|CPU|,
    1), the five factorizations 3e-4), ``potrf`` and ``potri`` at 1024^2
    timed; (e) ``resnet50_v1``'s
    parameters through ``nd.save(..., fmt="reference")`` and
    ``load_parameters`` into a fresh net on the card: logits bit-equal;
    a row-sparse and a csr entry through NDARRAY_V2; (f) ``sparse.dot``
    and the transposed dot at (b)'s shapes timed beside
    ``torch.sparse.mm`` (a yardstick, not on the path). K1 to K5 must not
    launch in it.

``python3 chip_smoke.py --phase 14`` builds the kernels and runs phase 14
alone; ``--phase 15``, ``--phase 17``, ``--phase 18``, ``--phase 19``
and ``--phase 20`` run that phase alone, building nothing; ``--phase 16`` builds the
kernels and runs phase 16 alone (no kernels line, no result line).

Launch counts are set to 0 just before phases 4, 5, 5c (its first
burst), 5e (its SLO burst), 5f, 8, 9 (each fused run), 10, saxpy's drive in
11, the 10 steps of 12, the 12 steps of 13 (a), phase 14 (a)'s fit, (c)'s
forward and backward and (d)'s chained predict, phase 15 (all
zero: no kernel of the port on the vision path), phase 16 (d)'s
quantized fit, phase 17 (all zero: none on the RNN path), phase 18
(all zero: none on the data path), phase 19 (all zero: none on the
detection path) and phase 20 (all zero: none on the sparse, linalg or
reference-format paths), and read just after.
The line before the last is the kernels' JSON record, with one K1, K2, K3
and K4 record for each route and the path it runs on (the sm90 records of
K1-K3 count phases 8, 13 (a), 14 (a) and 16 (d), the simt records of
K1-K3 phase 14 (c) besides their own), and four K5 records (plain
serving, phase 5; speculative verify, phase 5c with the times of phase
6b; the SLO
batched prefill, phase 5e; the router's two replicas, phase 5f), each
with its launches inside graph replays;
the whole smoke's time is printed before it; the last line is
``{"ok": true, "device": {...}}``.
Weights and data are random, from fixed seeds.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense) used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


SM90_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")
SIMT_SOURCES = ("flash_fwd", "flash_bwd")
NO_SPILL_SOURCES = SM90_SOURCES + ("dequant_decode",)
# a simt instantiation's mangled name: kernel, dtype (f or bf16), DMAX
_PTXAS_KERNEL = re.compile(
    r"\d(flash_[a-z_]+?_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def simt_instantiations(log):
    """``(kernel, dtype, DMAX, registers, spill stores, spill loads)`` for
    each instantiation in a simt kernel's compiler report."""
    out, name, spill = [], None, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name, spill = _PTXAS_KERNEL.search(ln), None
        elif name and _PTXAS_SPILL.search(ln):
            spill = tuple(int(x) for x in _PTXAS_SPILL.search(ln).groups())
        elif name and spill and _PTXAS_REGS.search(ln):
            out.append((name.group(1), "f32" if name.group(2) == "f"
                        else "bf16", int(name.group(3)),
                        int(_PTXAS_REGS.search(ln).group(1))) + spill)
            name = None
    return out


def check_build(build):
    """Prints the compiler's registers, shared memory and spills for every
    kernel. The simt kernels (K1 to K4 on the CUDA cores) must not spill at
    DMAX 64 and 128; the sm90 kernels must not spill, and their machine
    code must hold ``wgmma`` (``HGMMA``) and TMA loads (``UTMALDG``); K5
    (``dequant_decode``) must not spill, and its machine code must hold
    ``cp.async`` (``LDGSTS``)."""
    spills = []
    for name in build.SOURCES:
        if name in SIMT_SOURCES:
            insts = simt_instantiations(build.build_log(name))
            check(len(insts) == (6 if name == "flash_fwd" else 18),
                  f"{name}: {len(insts)} instantiations in the compiler's "
                  f"report")
            for kern, dt, dmax, regs, st, ld in insts:
                print(f"  ptxas {kern}<{dt}, DMAX {dmax}>: {regs} registers,"
                      f" spill stores {st} bytes, spill loads {ld} bytes",
                      flush=True)
                check(dmax == 256 or st + ld == 0,
                      f"{kern}<{dt}, DMAX {dmax}> spills: {st} + {ld} bytes")
                if st + ld:
                    spills.append((kern, dt, dmax, st, ld))
            continue
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
                if name in NO_SPILL_SOURCES and "spill" in ln:
                    check(" 0 bytes spill stores, 0 bytes spill loads" in ln,
                          f"{name} spills: {ln.strip()}")
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for name in SM90_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", build.lib_path(name)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        n_mma, n_tma = sass.count("HGMMA"), sass.count("UTMALDG")
        print(f"  sass {name}: {n_mma} HGMMA (wgmma), {n_tma} UTMALDG (TMA "
              f"loads)", flush=True)
        check(n_mma > 0 and n_tma > 0,
              f"{name}: no wgmma or no TMA load in its machine code")
    sass = subprocess.run([cuobjdump, "-sass",
                           build.lib_path("dequant_decode")],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    n_async = sass.count("LDGSTS")
    print(f"  sass dequant_decode: {n_async} LDGSTS (cp.async)", flush=True)
    check(n_async > 0, "dequant_decode: no cp.async in its machine code")
    print(f"simt spills (DMAX 256): {spills or 'none'}", flush=True)


def timed_ms(torch, fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
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


def _bound(flops, nbytes, dtype):
    """(bound ms, what bounds it) on the H100's data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_k1(torch, attention):
    """K1 against its plain version; returns the record of each main path
    by name: ``forward`` (f32, causal, the scoring forward's shape: the
    simt route) and ``train`` (bf16, causal, one training micro-batch: the
    sm90 route)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    # record: the main path the case stands for ("" timed only, None
    # checked only)
    cases = [  # (label, B, H, T, Tk, D, dtype, causal, out tol, record)
        ("f32 causal", 4, 12, 1024, 1024, 64, f32, True, 1e-4, "forward"),
        ("bf16 causal", 4, 12, 1024, 1024, 64, bf16, True, 1e-2, ""),
        ("bf16 causal, training shape", 8, 16, 1024, 1024, 64, bf16, True,
         1e-2, "train"),
        ("f32 causal ragged T=1000", 4, 12, 1000, 1000, 64, f32, True, 1e-4,
         None),
        ("f32 full T=1000 Tk=1021", 2, 4, 1000, 1021, 64, f32, False, 1e-4,
         None),
        ("f32 causal D=256", 1, 2, 200, 200, 256, f32, True, 1e-4, None),
        ("bf16 full D=40", 2, 3, 77, 130, 40, bf16, False, 1e-2, None),
        ("bf16 causal ragged T=1000", 4, 12, 1000, 1000, 64, bf16, True,
         1e-2, None),
        ("bf16 causal D=128", 1, 4, 300, 300, 128, bf16, True, 1e-2, None),
    ]
    recs = {}
    for label, B, H, T, Tk, D, dt, causal, tol, record in cases:
        q = torch.randn(B, H, T, D, device=dev, generator=g).to(dt)
        k = torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
        v = torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
        scale = 1.0 / math.sqrt(D)
        route = attention._fwd_route(dt, D)
        n0 = attention.flash_fwd.sm90_launches
        out, lse = attention.flash_fwd(q, k, v, causal, scale)
        ref, ref_lse = attention._chunk_reference_lse(q, k, v, causal, scale)
        torch.cuda.synchronize()
        check(attention.flash_fwd.sm90_launches - n0 == (route == "sm90"),
              f"K1 {label}: took the wrong route (want {route})")
        check(route == ("sm90" if dt == bf16 and D % 8 == 0 and D <= 128
                        else "simt"), f"K1 {label}: routed to {route}")
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        check(math.isfinite(err) and err <= tol and lse_err <= 1e-4,
              f"K1 {label}: out err {err} (tol {tol}), lse err {lse_err} "
              f"(tol 1e-4)")
        line = (f"K1 {label} B{B} H{H} T{T} Tk{Tk} D{D} ({route}): "
                f"max_abs_err out {err:.3e} (tol {tol:g}) lse {lse_err:.3e} "
                f"(tol 1e-4)")
        if record is None:
            print(line, flush=True)
            continue
        ms = timed_ms(torch, lambda: attention.flash_fwd(q, k, v, causal,
                                                        scale), 20)
        plain_ms = timed_ms(torch, lambda: attention._chunk_reference_lse(
            q, k, v, causal, scale), 10)
        lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), 20)
        elem = q.element_size()
        nbytes = (2 * B * H * T * D + 2 * B * H * Tk * D) * elem \
            + B * H * T * 4
        pairs = T * (T + 1) // 2 if causal else T * Tk    # causal: T == Tk
        flops = 4.0 * B * H * pairs * D
        bound_ms, bound_by = _bound(flops, nbytes,
                                    str(dt).replace("torch.", ""))
        print(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops:.3e} flops, {nbytes} bytes)", flush=True)
        if record:
            recs[record] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
    return recs


K5_CACHES = 12   # one cache per layer of the base model, as a serving step


def capture(torch, fn, iters):
    """``iters`` calls of ``fn`` captured into one CUDA graph (after one
    warm-up call on a side stream) and replayed once; returns the graph
    and the captured calls' results, which each replay writes anew."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(iters)]
    graph.replay()
    torch.cuda.synchronize()
    return graph, outs


def graph_ms(torch, fn, iters, reps=3):
    """Mean device time of one call of ``fn``: ``iters`` calls captured into
    one CUDA graph, replayed once to warm up, then ``reps`` times between
    CUDA events. The host's time per call (argument checks, ``ctypes``) is
    not in it: the replays launch back to back on the device."""
    def call():
        fn()    # not kept: each call's output memory is reused in the graph

    graph, _ = capture(torch, call, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def launch_floor_ms(torch, iters):
    """``graph_ms`` of one one-element ``add_`` per call: what a launch of
    a kernel that does nothing costs in a graph."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda: x.add_(1.0), iters)


def k5_caches(torch, kv_quant, g, S, H, TOT, D, mode, n):
    """``n`` quantized (kd, ks, vd, vs) caches of one shape."""
    out = []
    for _ in range(n):
        kd, ks = kv_quant.quantize_rows(
            torch.randn(S, H, TOT, D, device="cuda", generator=g), mode)
        vd, vs = kv_quant.quantize_rows(
            torch.randn(S, H, TOT, D, device="cuda", generator=g), mode)
        out.append((kd, ks, vd, vs))
    return out


def k5_cursors(torch, g, S, TOT, how, C):
    """``ragged``: first row, last row and spread between; ``last``: every
    slot at TOT - 1 (a prefill step's last position); ``past``: cursors
    past the bucket, which the kernel clips into it; ``early``: every
    cursor in chunk 0 of C positions, the last at C - 1 (a prefill's
    first positions in a page longer than C)."""
    if how == "early":
        pc = torch.randint(0, C, (S,), device="cuda", generator=g,
                           dtype=torch.int32)
        pc[-1] = C - 1
        return pc
    if how == "last":
        return torch.full((S,), TOT - 1, dtype=torch.int32, device="cuda")
    if how == "past":
        return torch.tensor([TOT + 37, 2 ** 31 - 1, 40][:S],
                            dtype=torch.int32, device="cuda")
    pc = torch.randint(0, TOT, (S,), device="cuda", generator=g,
                       dtype=torch.int32)
    pc[0], pc[-1] = 0, TOT - 1
    return pc


def k5_bytes(pc, H, TOT, D, q):
    """Bytes K5 must move: the K and V rows (one byte a value) and their
    f32 scales up to each slot's clipped cursor, q in, out, pc."""
    rows = int((pc.long().clamp(0, TOT - 1) + 1).sum().item()) * H
    return 2 * rows * (D + 4) + 2 * q.numel() * q.element_size() \
        + pc.numel() * 4, rows


def k5_error(torch, out, ref):
    """Largest error of K5's output against the plain version's f32
    result; for a bf16 output less half a bf16 step of each value (the one
    rounding of the f32 result to 8 significant bits, at most 2^-8 of
    it)."""
    diff = (out.float() - ref).abs()
    if out.dtype == torch.bfloat16:
        diff = diff - ref.abs() * 2.0 ** -8
    return diff.max().item()


def k5_followed(torch, quant_attention, q, caches, pc, scale, replays=3):
    """Largest error, against the plain version, of K5's output as a copy
    kernel that follows it in one CUDA graph reads it, one K5 call and one
    copy per cache, over ``replays`` replays: the kernel after K5 on the
    stream must see the whole output, also where K5's merge kernel has no
    chunk to merge and ends at once."""
    refs = [quant_attention._decode_plain(q.float(), *c, pc, scale)
            for c in caches]
    turn = [0]

    def call():
        turn[0] += 1
        i = turn[0] % len(caches)
        return i, quant_attention.dequant_decode(q, *caches[i], pc,
                                                 scale).clone()

    graph, outs = capture(torch, call, len(caches))
    err = 0.0
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        for i, out in outs:
            err = max(err, k5_error(torch, out, refs[i]))
    return err


def phase_k5(torch, quant_attention, kv_quant):
    """K5 against its plain version at 1e-5 x max(|ref|, 1). The timed
    cases cycle through ``K5_CACHES`` caches, as a serving step reads one
    cache per layer, and print the graph time (the record's ``ms``), the
    eager-call time (``eager_ms``), the launch floor, the plain version's
    graph time and the byte bound. The decode case runs twice and must
    give the same bits. Returns the main-path record (int8 cache, the
    engine's decode shape) with the last prefill shape's times in it."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, S, H, TOT, D, mode, q dtype, cursors, timed)
        ("decode int8", 8, 12, 1024, 64, "int8", f32, "ragged", True),
        ("decode fp8", 8, 12, 1024, 64, "fp8", f32, "ragged", True),
        ("prefill int8", 1, 12, 256, 64, "int8", f32, "last", True),
        ("prefill int8", 1, 12, 704, 64, "int8", f32, "last", True),
        ("wide head int8", 8, 16, 1024, 128, "int8", f32, "ragged", True),
        ("decode int8, q bf16", 8, 12, 1024, 64, "int8", bf16, "ragged",
         False),
        ("int8, pc past TOT", 3, 2, 96, 64, "int8", f32, "past", False),
        ("int8 D=40", 3, 2, 96, 40, "int8", f32, "ragged", False),
        ("fp8 D=40", 2, 3, 32, 40, "fp8", f32, "ragged", False),
        ("prefill int8, cursor in chunk 0", 1, 12, 704, 64, "int8", f32,
         "early", False),
        ("decode fp8, cursors in chunk 0", 8, 12, 1024, 64, "fp8", bf16,
         "early", False),
    ]
    iters = 10 * K5_CACHES
    floor_ms = launch_floor_ms(torch, iters)
    print(f"K5 launch floor (graph, one 1-element add_ per call): "
          f"{floor_ms:.5f} ms", flush=True)
    main, prefill = None, None
    for label, S, H, TOT, D, mode, qdt, how, do_time in cases:
        q = torch.randn(S, H, D, device=dev, generator=g).to(qdt)
        caches = k5_caches(torch, kv_quant, g, S, H, TOT, D, mode,
                           K5_CACHES if do_time or how == "early" else 1)
        C = quant_attention._card_chunk(dev, S, H, TOT, D)
        pc = k5_cursors(torch, g, S, TOT, how, C)
        scale = 1.0 / math.sqrt(D)
        out = quant_attention.dequant_decode(q, *caches[0], pc, scale)
        ref = quant_attention._decode_plain(q.float(), *caches[0], pc,
                                            scale)
        torch.cuda.synchronize()
        err = k5_error(torch, out, ref)
        tol = 1e-5 * max(ref.abs().max().item(), 1.0)
        check(out.dtype == qdt and math.isfinite(err) and err <= tol,
              f"K5 {label}: err {err} (tol {tol})")
        line = (f"K5 {label} S{S} H{H} TOT{TOT} D{D} q {str(qdt)[6:]} "
                f"C{C} pc={pc.tolist()}: max_abs_err {err:.3e} (tol "
                f"{tol:.3e})")
        if how == "early":
            check(TOT > C, f"K5 {label}: TOT {TOT} is not split at C {C}")
            err = k5_followed(torch, quant_attention, q, caches, pc, scale)
            check(math.isfinite(err) and err <= tol,
                  f"K5 {label}: read after it in a graph: err {err}")
            line += (f"; read by the next kernel of a graph, "
                     f"{K5_CACHES} calls x 3 replays: err {err:.3e}")
        if label == "decode int8":
            again = quant_attention.dequant_decode(q, *caches[0], pc, scale)
            check(torch.equal(out, again),
                  f"K5 {label}: a second run gave other bits")
            line += "; a second run bit-equal"
        if not do_time:
            print(line, flush=True)
            continue
        turn = [0]

        def cycled(fn):
            def call():
                turn[0] += 1
                return fn(q, *caches[turn[0] % K5_CACHES], pc, scale)
            return call

        ms = graph_ms(torch, cycled(quant_attention.dequant_decode), iters)
        eager_ms = timed_ms(torch, cycled(quant_attention.dequant_decode),
                            iters)
        plain_ms = graph_ms(torch, cycled(quant_attention._decode_plain),
                            2 * K5_CACHES, reps=1)
        nbytes, rows = k5_bytes(pc, H, TOT, D, q)
        bound_ms, bound_by = _bound(4.0 * rows * D, nbytes, "float32")
        cache_mb = K5_CACHES * sum(t.numel() * t.element_size()
                                   for t in caches[0]) / 1e6
        where = "stay in" if cache_mb < 50 else "exceed"
        print(f"{line}; kernel {ms:.5f} ms (graph), eager {eager_ms:.5f} "
              f"ms, launch floor {floor_ms:.5f} ms, plain {plain_ms:.4f} ms,"
              f" library none, bound {bound_ms:.5f} ms ({bound_by}: "
              f"{nbytes} bytes); {K5_CACHES} caches of {cache_mb:.1f} MB "
              f"in all {where} the 50 MB L2", flush=True)
        rec = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms,
                   launch_floor_ms=floor_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        if main is None:
            main = rec
            xla = xla_check(torch, quant_attention, q, caches, pc, scale,
                            iters, ms)
        if label == "prefill int8":
            prefill = dict(TOT=TOT, ms=ms, eager_ms=eager_ms,
                           bound_ms=bound_ms)
    k5_span_check(torch, quant_attention, kv_quant, g)
    float_span_check(torch)
    return dict(main, prefill=prefill, xla=xla)


def xla_check(torch, quant_attention, q, caches, pc, scale, iters, k5_ms):
    """The ``xla`` read (``_decode_xla``: the reference's non-Pallas read,
    plain ops with exact int32 sums) at the decode shape on the card:
    against its CPU result within 1e-5 x max(|CPU|, 1) (the sums are
    exact on both, so only the float epilogue may differ), and against
    K5's plain version within the reference's bound (3 x half an int8
    step of the V rows, ``tests/test_quant_attention.py``); timed on a
    graph beside K5's graph time. Plain ops, not a kernel: no K5
    launch."""
    xla_fn = quant_attention._decode_xla
    launches = quant_attention.dequant_decode.launches
    out = xla_fn(q, *caches[0], pc, scale)
    cpu = xla_fn(q.cpu(), *(t.cpu() for t in caches[0]), pc.cpu(), scale)
    ref = quant_attention._decode_plain(q.float(), *caches[0], pc, scale)
    torch.cuda.synchronize()
    check(quant_attention.dequant_decode.launches == launches,
          "the xla read launched K5")
    bound = 1.5 * caches[0][3].max().item()     # 3 x absmax / 254
    tol_cpu = 1e-5 * max(cpu.abs().max().item(), 1.0)
    err_cpu = (out.cpu() - cpu).abs().max().item()
    err_ref = (out - ref).abs().max().item()
    same = torch.equal(out.cpu(), cpu)
    check(math.isfinite(err_cpu) and err_cpu <= tol_cpu,
          f"xla read: card vs CPU {err_cpu} (tolerance {tol_cpu})")
    check(math.isfinite(err_ref) and err_ref <= bound,
          f"xla read: vs K5's plain version {err_ref} (bound {bound})")
    turn = [0]

    def cycled():
        turn[0] += 1
        return xla_fn(q, *caches[turn[0] % K5_CACHES], pc, scale)

    ms = graph_ms(torch, cycled, 2 * K5_CACHES, reps=2)
    S, H, TOT, D = caches[0][0].shape
    print(f"xla read (plain ops, int8 x int8 -> exact int32 sums) S{S} H{H} "
          f"TOT{TOT} D{D}: card vs CPU max diff {err_cpu:.3e} "
          f"({'bit-equal' if same else 'not bit-equal'}; tolerance "
          f"{tol_cpu:.3e}), vs K5's plain "
          f"version {err_ref:.3e} (bound {bound:.3e}); {ms:.5f} ms a call "
          f"on a graph against K5's {k5_ms:.5f} ({ms / k5_ms:.2f}x)",
          flush=True)
    return dict(ms=ms, err_cpu=err_cpu, tol_cpu=tol_cpu, err_plain=err_ref,
                bound=bound, k5_ms=k5_ms)


def k5_span_check(torch, quant_attention, kv_quant, g):
    """K5 over a (S8 H12 TOT832 D64) int8 cache and over the same cache
    zero-padded into TOT 1024, ragged cursors below 832: with ``span=1024``
    (the serving steps pass the model's ``max_len``) the two give the same
    bits, as they must for an engine's tokens not to depend on when it
    promoted its cache; without it C follows TOT and the bits may
    differ."""
    S, H, D = 8, 12, 64
    q = torch.randn(S, H, D, device="cuda", generator=g)
    small = k5_caches(torch, kv_quant, g, S, H, 832, D, "int8", 1)[0]
    big = []
    for t in small:
        pad = torch.zeros(t.shape[:2] + (1024,) + t.shape[3:], dtype=t.dtype,
                          device="cuda") if t.dim() == 4 else \
            torch.ones(t.shape[:2] + (1024,), device="cuda")
        pad[:, :, :832] = t
        big.append(pad)
    pc = k5_cursors(torch, g, S, 832, "ragged", 32)
    pc[-1] = 831
    scale = 1.0 / math.sqrt(D)
    a = quant_attention.dequant_decode(q, *small, pc, scale, 1024)
    b = quant_attention.dequant_decode(q, *big, pc, scale, 1024)
    c = quant_attention.dequant_decode(q, *small, pc, scale)
    d = quant_attention.dequant_decode(q, *big, pc, scale)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "K5 with span 1024: TOT 832 and the same cache "
          "padded to 1024 give other bits")
    print(f"K5 span: TOT 832 and the same cache zero-padded to 1024, "
          f"pc={pc.tolist()}: bit-equal with span=1024 (C "
          f"{quant_attention._card_chunk('cuda', S, H, 1024, D)}); without "
          f"span (C {quant_attention._card_chunk('cuda', S, H, 832, D)} vs "
          f"{quant_attention._card_chunk('cuda', S, H, 1024, D)}): "
          f"{'bit-equal' if torch.equal(c, d) else 'differ'}, max diff "
          f"{(c - d).abs().max().item():.3e}", flush=True)


def float_span_check(torch):
    """The float-cache step's read (``serving_step``, and ``build_step``'s
    ``_float_read`` under ``int8_w``), base width, one layer, S 8, ragged
    cursors: logits over a cache and over the same cache zero-padded into
    a larger bucket (TOT 256 -> 288, 704 -> 1024) must be bit-equal, as an
    engine's tokens must not depend on when it promoted its cache."""
    from mxtpu_torch.gluon.model_zoo import transformer as lm
    from mxtpu_torch.quant import serve
    net = lm.transformer_lm("base", vocab_size=50257, num_layers=1, seed=9)
    g = torch.Generator(device="cuda").manual_seed(10)
    S = 8
    w8 = serve.parse_quant("int8_w")
    steps = {"serving_step": (lambda T: net.serving_step(S, T),
                              net._gen_params()),
             "int8_w step": (lambda T: serve.build_step(net, S, T, w8),
                             serve.quantize_lm(net, w8))}
    lines = []
    with torch.inference_mode():
        for small, big in ((256, 288), (704, 1024)):
            cache = torch.randn(1, 2, S, 12, small, 64, device="cuda",
                                generator=g) * 0.3
            padded = torch.zeros(1, 2, S, 12, big, 64, device="cuda")
            padded[..., :small, :] = cache
            tok = torch.randint(0, 50257, (S,), device="cuda", generator=g)
            p = torch.randint(0, small, (S,), device="cuda", generator=g)
            p[0], p[-1] = 0, small - 1
            for name, (make, params) in steps.items():
                _, a = make(small)(params, cache.clone(), tok, p)
                _, b = make(big)(params, padded.clone(), tok, p)
                torch.cuda.synchronize()
                same = torch.equal(a, b)
                lines.append(f"{name} TOT {small} vs {big}: "
                             f"{'bit-equal' if same else 'differ'} (max "
                             f"diff {(a - b).abs().max().item():.3e})")
                check(same, f"float read: {lines[-1]}")
    print("float-cache read, a cache and the same cache zero-padded into a "
          "larger bucket (base width, S 8, ragged cursors): "
          + "; ".join(lines), flush=True)


def phase_bwd(torch, attention):
    """K2, K3 and K4 against the plain backward; returns the records at the
    training shape (causal) by dtype (``bf16``: the sm90 route, the
    training path; ``f32``: the simt route) and kernel name."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, B, H, T, Tk, D, dtype, causal, dlse, bf16 rows, timed)
        ("bf16 causal", 8, 16, 1024, 1024, 64, bf16, True, False, False,
         True),
        ("f32 causal", 8, 16, 1024, 1024, 64, f32, True, False, False, True),
        ("f32 causal dlse T=1000", 2, 4, 1000, 1000, 64, f32, True, True,
         False, False),
        ("f32 full dlse T=1000 Tk=1021", 2, 4, 1000, 1021, 64, f32, False,
         True, False, False),
        ("f32 causal T=200 Tk=333", 2, 3, 200, 333, 64, f32, True, True,
         False, False),
        ("f32 causal T=333 Tk=200", 2, 3, 333, 200, 64, f32, True, False,
         False, False),
        ("bf16 full D=40", 2, 3, 77, 130, 40, bf16, False, True, False,
         False),
        ("f32 causal D=40", 2, 3, 150, 150, 40, f32, True, False, False,
         False),
        ("f32 causal D=128", 1, 4, 300, 300, 128, f32, True, True, False,
         False),
        ("f32 causal D=256", 1, 2, 200, 200, 256, f32, True, True, False,
         False),
        ("f32 causal bf16 rows", 2, 4, 512, 512, 64, f32, True, True, True,
         False),
        # at this size cuBLAS sums the plain version's products in another
        # order than the kernels (at the sizes above it uses their order)
        ("f32 causal T=64", 1, 1, 64, 64, 64, f32, True, False, False,
         False),
        ("bf16 causal dlse T=1000 Tk=1021 D=40", 2, 4, 1000, 1021, 40, bf16,
         True, True, False, False),
        ("bf16 causal D=128 bf16 rows", 1, 4, 300, 300, 128, bf16, True,
         True, True, False),
        ("bf16 causal dlse T=200 Tk=333 D=128", 1, 4, 200, 333, 128, bf16,
         True, True, False, False),
    ]
    wrappers = {"K2": attention.flash_bwd_dq, "K3": attention.flash_bwd_dkv,
                "K4": attention.flash_bwd_fused}
    routers = {"K2": attention._dq_route, "K3": attention._dkv_route,
               "K4": attention._fused_route}
    recs_by_dtype = {}
    for (label, B, H, T, Tk, D, dt, causal, with_dlse, bf16_rows,
         do_time) in cases:
        q, dout = (torch.randn(B, H, T, D, device=dev, generator=g).to(dt)
                   for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
                for _ in range(2))
        dlse = torch.randn(B, H, T, device=dev, generator=g) \
            if with_dlse else None
        scale = 1.0 / math.sqrt(D)
        out, lse = attention.flash_fwd(q, k, v, causal, scale)
        os.environ["MXTPU_FLASH_LSE"] = "bf16" if bf16_rows else ""
        try:
            rows = attention._bwd_rows(out, lse, dout, dlse)
        finally:
            os.environ.pop("MXTPU_FLASH_LSE")
        args = (q, k, v, dout) + rows + (causal, scale)
        ref = attention._flash_bwd_plain(*args)
        route = "sm90" if dt == bf16 and D % 8 == 0 and D <= 128 else "simt"
        n0 = {kern: fn.sm90_launches for kern, fn in wrappers.items()}
        split = (attention.flash_bwd_dq(*args),) + \
            attention.flash_bwd_dkv(*args)
        fused = attention.flash_bwd_fused(*args) if T == Tk else None
        torch.cuda.synchronize()
        for kern, fn in wrappers.items():
            if kern == "K4" and fused is None:
                continue
            got = routers[kern](dt, D)
            check(got == route and fn.sm90_launches - n0[kern] == (
                route == "sm90"), f"{kern} {label}: routed to {got}, "
                f"{fn.sm90_launches - n0[kern]} sm90 launches (want {route})")
        tol_rel = 1e-4 if dt == f32 else 2e-2
        errs = {}
        for kern, outs in (("K2", split[:1]), ("K3", split[1:]),
                           ("K4", fused)):
            if outs is None:
                continue
            refs = ref[:1] if kern == "K2" else ref[1:] if kern == "K3" \
                else ref
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, refs))
            tol = tol_rel * max(max(r.float().abs().max().item()
                                    for r in refs), 1.0)
            check(math.isfinite(err) and err <= tol,
                  f"{kern} {label}: err {err} (tol {tol})")
            errs[kern] = (err, tol)
        if fused is None:
            same = "n/a (T != Tk)"
        else:
            # K4 runs the tile bodies of its route's K2 and K3: the same
            # sums in the same order
            for name, a, b in zip(("dq", "dk", "dv"), fused, split):
                check(torch.equal(a, b), f"K4 {label}: {name} differs from "
                      f"{'K2' if name == 'dq' else 'K3'}'s")
            same = "dq, dk, dv bit-equal"
        line = (f"K2/K3/K4 {label} B{B} H{H} T{T} Tk{Tk} D{D} ({route}): "
                f"max_abs_err "
                + ", ".join(f"{kk} {e:.3e} (tol {t:.3e})"
                            for kk, (e, t) in errs.items())
                + f"; K4 against K2 and K3: {same}")
        if not do_time:
            print(line, flush=True)
            continue
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                           scale=scale).backward(dout)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               scale=scale)

        # two rounds, each function in turn, the faster round kept: SDPA's
        # backward varies between calls (PERF.md), so the kernels are held
        # against it measured beside them
        timers = {
            "K2": lambda: timed_ms(
                torch, lambda: attention.flash_bwd_dq(*args), 10),
            "K3": lambda: timed_ms(
                torch, lambda: attention.flash_bwd_dkv(*args), 10),
            "K4": lambda: timed_ms(
                torch, lambda: attention.flash_bwd_fused(*args), 10),
            "sdpa": lambda: timed_ms(torch, sdpa_fwd_bwd, 10)
            - timed_ms(torch, sdpa_fwd, 10),
            "plain": lambda: timed_ms(
                torch, lambda: attention._flash_bwd_plain(*args), 3,
                warmup=1)}
        ms = {}
        for _ in range(2):
            for name, timer in timers.items():
                t = timer()
                ms[name] = min(ms.get(name, t), t)
        plain_ms, lib_ms = ms["plain"], ms["sdpa"]
        BH, elem = B * H, q.element_size()
        pairs = sum(min(i + 1, Tk) for i in range(T)) if causal else T * Tk
        in_bytes = BH * (2 * T + 2 * Tk) * D * elem \
            + 2 * BH * T * rows[0].element_size()
        q_bytes, kv_bytes = BH * T * D * elem, 2 * BH * Tk * D * elem
        # products of T x Tk x D the function needs: dq S, dP, dS K; dk, dv
        # S, dP, dS^T q, P^T dO; all three S, dP, dq, dk, dv (K4 runs K2's
        # body and K3's, 7 products, 7/5 of what it needs)
        work = {"K2": (3, in_bytes + q_bytes), "K3": (4, in_bytes + kv_bytes),
                "K4": (5, in_bytes + q_bytes + kv_bytes)}
        recs = {}
        for kern, (products, nbytes) in work.items():
            flops = 2.0 * products * BH * pairs * D
            bound_ms, bound_by = _bound(flops, nbytes,
                                        str(dt).replace("torch.", ""))
            recs[kern] = dict(max_abs_err=errs[kern][0], ms=ms[kern],
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms)
            line += (f"; {kern} {ms[kern]:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}: {flops:.3e} flops, {nbytes} bytes)")
        print(f"{line}; plain backward {plain_ms:.4f} ms, sdpa backward "
              f"{lib_ms:.4f} ms; K2 / sdpa backward {ms['K2'] / lib_ms:.3f}, "
              f"K4 / (K2 + K3) {ms['K4'] / (ms['K2'] + ms['K3']):.3f}",
              flush=True)
        recs_by_dtype.setdefault("bf16" if dt == bf16 else "f32", recs)
    split_vs_fused(torch, attention, g)
    return recs_by_dtype


def split_vs_fused(torch, attention, g):
    """Times the split pair (K2 then K3) against K4 at self-attention
    shapes off the training one: a small grid (B*H = 4), and no causal
    mask."""
    dev = torch.device("cuda")
    for B, H, causal in ((1, 4, True), (1, 4, False), (8, 16, False)):
        T, D = 1024, 64
        q, k, v, dout = (torch.randn(B, H, T, D, device=dev, generator=g)
                         .to(torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(D)
        out, lse = attention.flash_fwd(q, k, v, causal, scale)
        args = (q, k, v, dout) + attention._bwd_rows(out, lse, dout, None) \
            + (causal, scale)
        split_ms = timed_ms(torch, lambda: (attention.flash_bwd_dq(*args),
                                            attention.flash_bwd_dkv(*args)),
                            10)
        fused_ms = timed_ms(torch, lambda: attention.flash_bwd_fused(*args),
                            10)
        print(f"split vs fused, bf16 {'causal' if causal else 'full'} B{B} "
              f"H{H} T{T} D{D}: K2 + K3 {split_ms:.4f} ms, K4 "
              f"{fused_ms:.4f} ms", flush=True)


def phase_forward(torch, lm, attention, counts):
    model = lm.transformer_lm("base", vocab_size=50257)   # device None: card
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 50257, (4, 1024), device="cuda", generator=g)
    counts(0)
    with torch.inference_mode():
        t0 = time.monotonic()
        logits = model(tokens)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches = attention.flash_fwd.launches
    check(tuple(logits.shape) == (4, 1024, 50257),
          f"forward logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    check(launches > 0, "the forward launched no flash_fwd kernel")
    del logits
    with torch.inference_mode():
        steady = timed_ms(torch, lambda: model(tokens), 5, warmup=1)
    print(f"forward base (4, 1024): logits finite, {wall * 1e3:.1f} ms "
          f"first call, {steady:.2f} ms steady; flash_fwd launches "
          f"{launches} (one forward)", flush=True)
    return model, launches


def serving_prompts(torch, seed=4):
    lens = [64, 100, 170, 250, 333, 480, 600, 700]
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 50257, (n,), generator=g).tolist()
            for n in lens]


def program_traces(step_cache):
    """Traces (builds and captures) of the serving programs so far."""
    snap = step_cache.snapshot()
    return {k: snap.get(k, {}).get("traces", 0)
            for k in ("serving_prefill", "serving_decode", "serving_verify")}


def serve_wave(torch, serving, eng, prompts):
    """The prompts through ``eng`` at once, 128 new tokens each: (requests,
    wall seconds, TTFT ms sorted)."""
    t0 = time.monotonic()
    reqs = [eng.submit(p, 128) for p in prompts]
    outs = [r.result(timeout=900) for r in reqs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r, o in zip(reqs, outs):
        check(r.state == serving.DONE and len(o) == 128,
              f"request {r.id}: state {r.state}, {len(o)} tokens")
    return reqs, wall, sorted((r.t_first_token - r.t_submit) * 1e3
                              for r in reqs)


def phase_serving(torch, model, serving, quant_attention, step_cache,
                  counts):
    """The burst through ``ServingEngine(slots=8, quant="int8_kv")``, then
    a second burst of other prompts of the same lengths through the same
    engine. Every prefill and decode chunk must run as a CUDA graph
    replay, with one capture per program key in the first burst and none
    in the second; K5's launches must be exactly what the replays and the
    captures' one-step warm-ups ran: L x (prefill positions + decode steps
    + programs captured)."""
    prompts = serving_prompts(torch)
    pbs = [-(-len(p) // 32) * 32 for p in prompts]
    L = len(model.blocks)
    traces0 = program_traces(step_cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    counts(0)
    with serving.ServingEngine(model, slots=8, quant="int8_kv") as eng:
        reqs, wall, ttft = serve_wave(torch, serving, eng, prompts)
        stats = eng.stats()
        launches = quant_attention.dequant_decode.launches
        traces = {k: v - traces0[k]
                  for k, v in program_traces(step_cache).items()}
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        _, wall2, ttft2 = serve_wave(torch, serving, eng,
                                     serving_prompts(torch, 5))
        stats2 = eng.stats()
        launches2 = quant_attention.dequant_decode.launches - launches
        traces2 = {k: v - traces0[k]
                   for k, v in program_traces(step_cache).items()}
        chunk, pchunk = eng.chunk, eng.prefill_chunk
        # the router phase's references: the first burst's tokens, and the
        # same engine over the router's 4 shared-block prompts
        refs = [r.result() for r in reqs]
        extra = [eng.submit(p, 128) for p in router_prompts(torch)]
        refs += [r.result(timeout=900) for r in extra]
    check(launches > 0, "serving launched no dequant_decode kernel")
    check(launches % L == 0, f"{launches} dequant_decode launches is not a "
          f"multiple of the {L} layers: a step skipped the kernel")
    keys = {(pb, min(pchunk, pb - s)) for pb in pbs
            for s in range(0, pb, pchunk)}
    captured = stats.get("programs_captured", 0)
    for st in (stats, stats2):
        check(st.get("prefill_replays") == st["prefill_chunks"]
              and st.get("decode_replays") == st["decode_steps"],
              f"a chunk ran outside a graph replay: {st}")
    check(traces["serving_prefill"] == len(keys)
          and captured == sum(traces.values()),
          f"captures {captured}, traces {traces}: not one per key "
          f"({len(keys)} prefill keys)")
    check(traces2 == traces and stats2["programs_captured"] == captured,
          f"the second burst traced again: {traces2} after {traces}")
    steps = sum(pbs) + stats["decode_steps"] * chunk
    check(launches == L * (steps + captured),
          f"{launches} dequant_decode launches, not {L} x ({steps} steps "
          f"replayed + {captured} one-step warm-ups)")
    steps2 = sum(pbs) + (stats2["decode_steps"] - stats["decode_steps"]) \
        * chunk
    check(launches2 == L * steps2,
          f"second burst: {launches2} dequant_decode launches, not {L} x "
          f"{steps2} steps replayed")
    print(f"serving base int8_kv slots=8: 8 requests x 128 tokens in "
          f"{wall:.2f} s = {8 * 128 / wall:.1f} tokens/s; TTFT ms median "
          f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; dequant_decode "
          f"launches {launches} ({launches // L} steps x {L} layers: "
          f"{steps} replayed, {captured} warm-up); "
          f"kv_dtype {stats['kv_dtype']}, "
          f"kv_bytes_resident {stats['kv_bytes_resident']}, prefills "
          f"{stats.get('prefills')}, prefill_chunks "
          f"{stats.get('prefill_chunks')}, decode_steps "
          f"{stats.get('decode_steps')}", flush=True)
    print(f"serving programs: {captured} captured ({traces['serving_prefill']}"
          f" prefill keys (PB, csize), {traces['serving_decode']} decode keys "
          f"(slots, TOT, chunk)) in {stats.get('capture_ms_total', 0):.1f} ms"
          f" ({stats.get('capture_record_ms_total', 0):.1f} ms of it running"
          f" the bodies under capture, the rest warm-up and instantiation)"
          f"; replays: prefill {stats.get('prefill_replays')}, decode "
          f"{stats.get('decode_replays')}; peak memory allocated {peak} "
          f"bytes ({peak - mem0} above the {mem0} held before), reserved "
          f"{reserved}", flush=True)
    print(f"serving second burst (other prompts, same lengths, same engine: "
          f"no capture): {wall2:.2f} s = {8 * 128 / wall2:.1f} tokens/s; TTFT"
          f" ms median {ttft2[len(ttft2) // 2]:.1f} max {ttft2[-1]:.1f}; "
          f"replays: prefill "
          f"{stats2['prefill_replays'] - stats['prefill_replays']}, decode "
          f"{stats2['decode_replays'] - stats['decode_replays']}; "
          f"dequant_decode launches {launches2} ({steps2} steps x {L} "
          f"layers)", flush=True)
    return launches, L * steps, refs


def profile_events(torch, prof):
    """``(name, on the device, µs)`` of each event of a finished
    ``torch.profiler`` run, read from its raw results: ``prof.events()``
    builds a Python object and a tree for every event (~90 µs each on the
    host), which for a profiled serving wave of ~10^6 kernels took
    minutes. The events ``prof.events()`` leaves out (hidden ones, the
    allocator's records, the profiler's own calls) are left out here, so
    the device events are the same; host ops nested in an op of their own
    name are not merged as there (the callers count only the host's
    ``serving/*`` spans)."""
    from torch.autograd.profiler_util import _filter_name
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        yield name, e.device_type() == cuda, e.duration_ns() / 1e3


def phase_profile(torch, model, serving):
    """Where the serving time goes: two of the burst's requests (prompts of
    170 and 250 tokens, 128 new) through one engine twice: the first wave
    captures its programs, the second replays them under
    ``torch.profiler`` (device activity only; the profiler's processing
    grows with the kernel count, so the window is kept short; no prefix
    cache, so the second wave prefills in full). Reports the
    device's busy share of the second wave's wall time, the kernels that
    take it, and K5's launches and mean device time per launch (its
    kernels' names hold ``dequant_``)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    from mxtpu_torch.observability import tracer
    prompts = serving_prompts(torch)[2:4]
    with serving.ServingEngine(model, slots=8, quant="int8_kv",
                               prefix_cache_mb=0) as eng:
        t0 = time.monotonic()
        for r in [eng.submit(p, 128) for p in prompts]:
            r.result(timeout=900)
        first_ms = (time.monotonic() - t0) * 1e3
        tracer.start()
        try:
            # the spans run on the engine's scheduler thread
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True)) as prof:
                t0 = time.monotonic()
                for r in [eng.submit(p, 128) for p in prompts]:
                    r.result(timeout=900)
                torch.cuda.synchronize()
                wall_us = (time.monotonic() - t0) * 1e6
        finally:
            tracer.stop()
            tracer.reset()
        stats = eng.stats()
    by_name, k5, spans = {}, {}, {}
    for name, on_device, us in profile_events(torch, prof):
        if name.startswith("serving/"):
            # the spans, on the host and mirrored onto the device's
            # timeline as annotations: not kernels
            if not on_device:
                spans[name] = spans.get(name, 0) + 1
            continue
        if on_device:
            by_name[name] = by_name.get(name, 0.0) + us
            if "dequant_" in name:
                n, tot = k5.get(name, (0, 0.0))
                k5[name] = (n + 1, tot + us)
    busy = sum(by_name.values())
    captured = stats.get("programs_captured")
    check(spans.get("serving/decode", 0) > 0
          and spans.get("serving/prefill_chunk", 0) > 0,
          f"the engine's serving/* spans are not in the profile: {spans}")
    print(f"profile serving: the engine's spans in the torch.profiler trace "
          f"(tracer on): {spans}", flush=True)
    print(f"profile serving: first wave (captures {captured} programs in "
          f"{stats.get('capture_ms_total', 0):.1f} ms) {first_ms:.1f} ms; "
          f"second wave (2 x 128, replays only, profiler on) "
          f"{wall_us / 1e3:.1f} ms", flush=True)
    if not busy:
        print("profile: the profiler recorded no device time", flush=True)
        return
    print(f"profile serving (2 x 128, profiler on): wall {wall_us / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of "
          f"wall, idle {1 - busy / wall_us:.3f}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / busy:.3f} of device time, {us / 1e3:.1f} ms: "
              f"{name[:110]}", flush=True)
    for name, (n, us) in sorted(k5.items()):
        print(f"profile K5: {n} launches, mean {us / n:.3f} us, "
              f"{us / busy:.3f} of device time: {name[:90]}", flush=True)


# ---------------------------------------------------------------------------
# speculative decode and int8 weights (phases 5b-5d)
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_SAMPLED = 2        # the burst's one sampled request (170 tokens)
# the verify step's int8_w logits, card against CPU: (largest difference,
# least share of (slot, position) rows within 1e-4). A row whose int8
# activation codes agree on both sides matches to f32 reassociation (~1e-6
# here); where an LN, GELU or attention output sits at a code's rounding
# boundary, the ulp of difference between the two sides moves that code
# one step, and the row's logits by up to ~5e-2 at base width, so some
# rows, but fewer than half, move. The phase prints the same effect on the
# CPU alone: its logits again with the position table scaled by 1 + 1e-6
VERIFY_LOGITS_TOL = (0.1, 0.5)


def spec_prompts(torch, seed):
    """``serving_prompts`` with the 333- and 480-token prompts sharing
    their first 256 tokens (8 prefix-cache blocks)."""
    prompts = serving_prompts(torch, seed)
    prompts[5][:256] = prompts[4][:256]
    return prompts


def spec_wave(torch, serving, eng, prompts):
    """``serve_wave`` with request ``SPEC_SAMPLED`` sampling (temperature
    0.8, top-k 40, seed 1234): (tokens, wall s, TTFT ms sorted)."""
    sp = serving.SamplingParams(temperature=0.8, top_k=40, seed=1234)
    t0 = time.monotonic()
    reqs = [eng.submit(p, 128, sampling=sp if i == SPEC_SAMPLED else None)
            for i, p in enumerate(prompts)]
    outs = [r.result(timeout=900) for r in reqs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r, o in zip(reqs, outs):
        check(r.state == serving.DONE and len(o) == 128,
              f"request {r.id}: state {r.state}, {len(o)} tokens")
    return outs, wall, sorted((r.t_first_token - r.t_submit) * 1e3
                              for r in reqs)


def spec_leg(torch, model, serving, quant_attention, step_cache, quant, k,
             bursts, zero_counts=None, profile_prompts=None):
    """The bursts through one ``ServingEngine(slots=8, quant=quant,
    spec=k, prefix_cache_mb=64)``; per burst the tokens, wall, TTFT, the
    engine's stats and K5's launches and the program traces it added.
    ``zero_counts`` is called just before the first burst. Returns (per
    burst, peak bytes allocated in the first burst above what was held
    before, verify keys built, the profile of ``profile_prompts`` run
    after the bursts, or None)."""
    spec = serving.SpecConfig(k=k) if k else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    out, peak, prof = [], None, None
    with serving.ServingEngine(model, slots=8, quant=quant, spec=spec,
                               prefix_cache_mb=64) as eng:
        for i, prompts in enumerate(bursts):
            if i == 0 and zero_counts is not None:
                zero_counts(0)
            st0 = eng.stats()
            tr0 = program_traces(step_cache)
            l0 = quant_attention.dequant_decode.launches
            toks, wall, ttft = spec_wave(torch, serving, eng, prompts)
            st = eng.stats()
            if peak is None:
                peak = torch.cuda.max_memory_allocated() - mem0
            delta = {key: st[key] - st0.get(key, 0) for key in st
                     if isinstance(st[key], (int, float))
                     and not isinstance(st[key], bool)}
            h0 = st0.get("accept_len_hist", {})
            delta["accept_len_hist"] = {
                e: n - h0.get(e, 0)
                for e, n in sorted(st.get("accept_len_hist", {}).items())
                if n > h0.get(e, 0)}
            out.append(dict(
                toks=toks, wall=wall, ttft=ttft, stats=st, delta=delta,
                launches=quant_attention.dequant_decode.launches - l0,
                traces={key: v - tr0[key] for key, v in
                        program_traces(step_cache).items()}))
        chunk = eng.chunk
        keys = len(eng._verify_fns) + eng._verify_fns.evictions
        if profile_prompts is not None:
            prof = profile_wave(torch, eng, profile_prompts)
    return out, peak, keys, chunk, prof


def profile_wave(torch, eng, prompts):
    """``prompts`` (128 new each) through ``eng``, whose programs are all
    captured, under ``torch.profiler`` (device activity): (wall ms, device
    busy ms, {kernel name: (launches, device us)}, stats delta)."""
    from torch.profiler import ProfilerActivity, profile
    st0 = eng.stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for r in [eng.submit(p, 128) for p in prompts]:
            r.result(timeout=900)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    st = eng.stats()
    by_name = {}
    for name, on_device, us in profile_events(torch, prof):
        if on_device:
            n, tot = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, tot + us)
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    delta = {key: st[key] - st0.get(key, 0) for key in st
             if isinstance(st[key], (int, float))
             and not isinstance(st[key], bool)}
    return wall_ms, busy_ms, by_name, delta


def spec_burst_line(label, b):
    st, d = b["stats"], b["delta"]
    ttft = b["ttft"]
    return (f"{label}: 8 requests x 128 tokens in {b['wall']:.2f} s = "
            f"{8 * 128 / b['wall']:.1f} tokens/s; TTFT ms median "
            f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; captures "
            f"{d.get('programs_captured', 0)} in "
            f"{d.get('capture_ms_total', 0):.1f} ms (traces {b['traces']});"
            f" decode turns {d.get('decode_steps', 0)} (verify "
            f"{d.get('spec_dispatches', 0)}); dequant_decode launches "
            f"{b['launches']}; kv_dtype {st['kv_dtype']}")


def check_spec_burst(label, b, L, chunk, K1, verify_keys=None, k5=True):
    """Every chunk and dispatch of the burst a replay, one trace per
    program key (none when ``verify_keys`` is None: a burst after the
    first), and K5's launches exactly L x (prefill positions + decode
    chunks x chunk + K1 x verify dispatches + the captures' warm-ups), or
    none over a float cache (``k5=False``)."""
    d, tr = b["delta"], b["traces"]
    check(d.get("prefill_replays", 0) == d.get("prefill_chunks", 0)
          and d.get("decode_replays", 0) + d.get("verify_replays", 0)
          == d.get("decode_steps", 0)
          and d.get("verify_replays", 0) == d.get("spec_dispatches", 0),
          f"{label}: a chunk or dispatch ran outside a replay: {d}")
    captured = d.get("programs_captured", 0)
    check(captured == sum(tr.values()), f"{label}: {captured} captures "
          f"for traces {tr}")
    if verify_keys is None:
        check(captured == 0, f"{label}: traced again: {tr}")
    elif K1 > 1:
        check(tr["serving_verify"] == verify_keys >= 1,
              f"{label}: {tr['serving_verify']} verify traces for "
              f"{verify_keys} keys")
    spec = d.get("spec_dispatches", 0)
    warm = tr["serving_prefill"] + tr["serving_decode"] \
        + K1 * tr["serving_verify"]
    steps = d.get("prefill_positions", 0) \
        + (d.get("decode_steps", 0) - spec) * chunk + K1 * spec
    want = L * (steps + warm) if k5 else 0
    check(b["launches"] == want,
          f"{label}: {b['launches']} dequant_decode launches, not {want}: "
          f"{L} x ({steps} positions replayed + {warm} in warm-ups)"
          f"{'' if k5 else ' over an int8 cache, none over a float one'}")
    return steps, warm


def spec_stats_line(label, b):
    d = b["delta"]
    drafted = d.get("tokens_drafted", 0)
    n = d.get("accept_len_count", 0)
    return (f"{label}: verify dispatches {d.get('spec_dispatches', 0)} "
            f"(replays {d.get('verify_replays', 0)}), decode chunks "
            f"{d.get('decode_steps', 0) - d.get('spec_dispatches', 0)}; "
            f"tokens drafted {drafted}, accepted "
            f"{d.get('tokens_accepted', 0)}, rejected "
            f"{d.get('tokens_rejected', 0)}; accept length mean "
            f"{d.get('accept_len_total', 0) / max(n, 1):.3f} over {n} slot "
            f"dispatches, histogram {{length: slots}} "
            f"{d['accept_len_hist']}; n-gram hits "
            f"{d.get('ngram_hits', 0)} misses {d.get('ngram_misses', 0)}; "
            f"prefix-cache hits {d.get('prefix_hits', 0)} "
            f"({d.get('prefix_hit_tokens', 0)} tokens); drafter host "
            f"{d.get('draft_ms_total', 0):.1f} ms = "
            f"{d.get('draft_ms_total', 0) / (b['wall'] * 1e3):.4f} of wall")


def phase_spec(torch, model, serving, quant_attention, step_cache, counts,
               smi):
    """Speculative serving at base width: ``int8_kv,int8_w`` with
    ``spec=SpecConfig(k=4)`` (a burst of the phase-5 lengths, two
    prompts sharing 256 tokens, one sampled request), the same without
    ``spec``, then ``int8_kv`` (f32 weights) and a float cache
    (``quant=None``) with and without ``spec``. Tokens equal leg for leg;
    every verify dispatch a replay; no capture in the profiled wave after
    the speculative burst; K5's launches exact (none over the float
    cache); a prefix-cache hit. Returns the speculative leg's K5 launches,
    those inside replays, and the tokens of the spec-less ``int8_kv`` and
    float legs."""
    L, K1 = len(model.blocks), SPEC_K + 1
    bursts = [spec_prompts(torch, 4)]
    legs = {}
    for name, quant, k, zero in (
            ("spec int8_kv,int8_w", "int8_kv,int8_w", SPEC_K, counts),
            ("reference int8_kv,int8_w", "int8_kv,int8_w", 0, None),
            ("spec int8_kv", "int8_kv", SPEC_K, None),
            ("reference int8_kv", "int8_kv", 0, None),
            ("spec float", None, SPEC_K, None),
            ("reference float", None, 0, None)):
        legs[name] = spec_leg(
            torch, model, serving, quant_attention, step_cache, quant, k,
            bursts, zero,
            profile_prompts=serving_prompts(torch, 6)[2:4]
            if name == "spec int8_kv,int8_w" else None)
        torch.cuda.empty_cache()
    spec_b, peak_a, keys, chunk, prof = legs["spec int8_kv,int8_w"]
    differ = []
    for a, b in (("spec int8_kv,int8_w", "reference int8_kv,int8_w"),
                 ("spec int8_kv", "reference int8_kv"),
                 ("spec float", "reference float")):
        for i, (x, y) in enumerate(zip(legs[a][0], legs[b][0])):
            for r, (s_, t_) in enumerate(zip(x["toks"], y["toks"])):
                if s_ != t_:
                    j = next(n for n, (u, v) in enumerate(zip(s_, t_))
                             if u != v)
                    differ.append(
                        f"{a} burst {i + 1} request {r}"
                        f"{' (sampled)' if r == SPEC_SAMPLED else ''}: "
                        f"tokens differ from {b}'s at new token {j}")
    check(not differ, "; ".join(differ))
    steps, warm = check_spec_burst("spec burst 1", spec_b[0], L, chunk, K1,
                                   keys)
    check(prof[3].get("programs_captured", 0) == 0,
          f"the profiled wave after the speculative burst captured "
          f"{prof[3].get('programs_captured')} programs")
    for name in ("reference int8_kv,int8_w", "spec int8_kv",
                 "reference int8_kv", "spec float", "reference float"):
        b = legs[name][0][0]
        check_spec_burst(name, b, L, chunk,
                         K1 if name.startswith("spec") else 1,
                         legs[name][2], k5="float" not in name)
    for name in ("spec int8_kv,int8_w", "spec int8_kv", "spec float"):
        d = legs[name][0][0]["delta"]
        check(d.get("spec_dispatches", 0) > 0,
              f"{name}: no verify dispatch ran")
        check(d.get("tokens_accepted", 0) + d.get("tokens_rejected", 0)
              == d.get("tokens_drafted", 0), f"{name}: drafted != "
              f"accepted + rejected: {d}")
    check(spec_b[0]["delta"].get("prefix_hits", 0) >= 1,
          "the speculative leg's first burst hit no prefix-cache block")
    print(f"speculative serving (base, slots=8, k={SPEC_K}, prefix_cache_mb"
          f"=64, 2 prompts sharing 256 tokens, request {SPEC_SAMPLED} "
          f"sampled at temperature 0.8, top-k 40) on {smi}:", flush=True)
    for name, (bs, peak, _, _, _) in legs.items():
        for i, b in enumerate(bs):
            print("  " + spec_burst_line(f"{name} burst {i + 1}", b),
                  flush=True)
        print(f"  {name}: peak memory allocated in burst 1 {peak} bytes "
              f"above what was held before", flush=True)
    for name in ("spec int8_kv,int8_w", "spec int8_kv", "spec float"):
        for i, b in enumerate(legs[name][0]):
            print("  " + spec_stats_line(f"{name} burst {i + 1}", b),
                  flush=True)
    print(f"  tokens: every request of every burst equal to the spec-less "
          f"engine's (greedy and sampled), in all three legs; K5 launches "
          f"(spec burst 1) {spec_b[0]['launches']} = {L} x ({steps} "
          f"positions + {warm} warm-up); verify keys {keys}, one trace "
          f"each, none in the profiled wave after it; every verify dispatch"
          f" a replay", flush=True)
    if prof is not None:
        wall_ms, busy_ms, by_name, d = prof
        print(f"profile speculative int8_kv,int8_w (prompts of 170 and 250 "
              f"tokens x 128, replays only, profiler on): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms = "
              f"{busy_ms / wall_ms:.3f}; verify dispatches "
              f"{d.get('spec_dispatches', 0)}, decode chunks "
              f"{d.get('decode_steps', 0) - d.get('spec_dispatches', 0)}, "
              f"prefill chunks {d.get('prefill_chunks', 0)}; drafter "
              f"{d.get('draft_ms_total', 0):.1f} ms", flush=True)
        busy_us = busy_ms * 1e3
        for kname, (n, us) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][1])[:10]:
            print(f"  {us / busy_us:.3f} of device time, {n} launches, "
                  f"{us / 1e3:.1f} ms: {kname[:100]}", flush=True)
        k5 = [(n, us) for kname, (n, us) in by_name.items()
              if "dequant_" in kname]
        if k5:
            n = sum(x for x, _ in k5)
            us = sum(x for _, x in k5)
            print(f"  K5 (chunk and merge kernels): {n} launches, "
                  f"{us / busy_us:.3f} of device time, {us / n:.3f} us a "
                  f"launch", flush=True)
    b = spec_b[0]
    return b["launches"], L * steps, {
        "int8_kv": legs["reference int8_kv"][0][0]["toks"],
        None: legs["reference float"][0][0]["toks"]}


# ---------------------------------------------------------------------------
# the serving control plane (phase 5e)
# ---------------------------------------------------------------------------

# tenant -> (name, tier, prompt lengths, new tokens)
SLO = dict(low=("bulk", "batch", (400, 700), 128),
           high=("chat", "interactive", (64, 200), 64))
SLO_N = 8             # requests a tenant
SLO_BATCH = 4         # prefill_batch
SLO_STALL_S = 60.0    # the watchdog's deadline, above any capture
SLO_PILOT = (250, 6)  # the pilot's prompt and new tokens: one bucket


def slo_trace():
    """Each tenant's first ``SLO_N`` requests of a seeded two-tenant
    ``sched.replay`` trace ("bursty"), each prompt cut to a length drawn
    from the tenant's range, and a pilot (the low tenant's next request,
    cut to ``SLO_PILOT``): {"low"/"high": [(prompt, new, name, tier)],
    "pilot": [one]}."""
    import random
    from mxtpu_torch.sched import replay
    profiles = tuple(replay.TenantProfile(name, tier, prefix_len=0,
                                          suffix_len=hi, max_new=new)
                     for name, tier, (_, hi), new in SLO.values())
    trace = replay.make_trace("bursty", seed=11, rate=24.0, duration_s=4.0,
                              vocab=50257, tenants=profiles)
    rng = random.Random(11)
    out = {}
    for key, (name, tier, (lo, hi), new) in SLO.items():
        reqs = [r for r in trace.requests if r.tenant == name][:SLO_N + 1]
        check(len(reqs) == SLO_N + 1, f"the trace has {len(reqs)} {name} "
              f"requests, not {SLO_N + 1}")
        out[key] = [(list(r.prompt[:rng.randint(lo, hi)]), r.max_new,
                     r.tenant, r.priority) for r in reqs[:SLO_N]]
        if key == "low":
            r = reqs[SLO_N]
            out["pilot"] = [(list(r.prompt[:SLO_PILOT[0]]), SLO_PILOT[1],
                             r.tenant, r.priority)]
    return out


def slo_burst(torch, serving, eng, trace):
    """The pilot, then the low tenant's requests at once: the pilot's
    prefill (it completes at admission, in its bucket, taking no slot)
    holds the scheduler while they are staged, so they prefill in two
    groups of ``SLO_BATCH``. Once the first group decodes, the high
    tenant's requests: they wait out the second group's prefill, and when
    it ends every slot holds a batch-tier request with tokens still to
    go, so they preempt. Returns the requests, pilot, low then high, and
    the slots active when the high tenant arrived."""
    reqs = [eng.submit(p, n, tenant=t, priority=pr)
            for p, n, t, pr in trace["pilot"] + trace["low"]]
    t0 = time.monotonic()
    while eng.load()["active"] < SLO_BATCH:
        check(time.monotonic() - t0 < 600, "the first batched group never "
              "reached decode")
        time.sleep(0.001)
    active = eng.load()["active"]
    reqs += [eng.submit(p, n, tenant=t, priority=pr)
             for p, n, t, pr in trace["high"]]
    for r in reqs:
        r.result(timeout=900)
    torch.cuda.synchronize()
    for r in reqs:
        check(r.state == serving.DONE and len(r.tokens()) == r.max_new,
              f"request {r.id}: state {r.state}, {len(r.tokens())} tokens")
    return reqs, active


def tenant_line(reqs, row):
    ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
    wall = max(r.t_done for r in reqs) - min(r.t_submit for r in reqs)
    toks = sum(len(r.tokens()) for r in reqs)
    return (f"{reqs[0].tenant} ({reqs[0].priority}): {toks} tokens in "
            f"{wall:.2f} s = {toks / wall:.1f} tokens/s, TTFT ms median "
            f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; shed "
            f"{row.get('shed', 0)}, preempted {row.get('preempted', 0)}, "
            f"resumed {row.get('resumed', 0)}")


def batched_chunk_ms(torch, eng):
    """Device time of one replay of the engine's batched prefill chunk at
    its largest bucket and of its B=1 chunk there (full chunks), each
    replayed 5 times over the state of its last call: ((key, ms), (key,
    ms))."""
    progs = dict(zip(eng._prefill_fns._fns.keys(), eng._prefill_fns.values()))
    full = eng.prefill_chunk
    batched = max((k for k in progs if k[0] == "batch" and k[3] == full),
                  key=lambda k: k[2])
    plain = [k for k in progs if k[0] != "batch" and k[1] == full]
    plain = min(plain, key=lambda k: abs(k[0] - batched[2]))
    out = []
    for key in (batched, plain):
        prog = progs[key]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            prog.graph.replay()
        end.record()
        end.synchronize()
        out.append((key, start.elapsed_time(end) / 5))
    return out


def k5_batched_record(torch, quant_attention, kv_quant):
    """K5 at the batched prefill's shape (S ``SLO_BATCH``, H 12, PB 704,
    D 64, every cursor at the last position, ``span=1024``,
    ``plan_slots=1`` as the batched step calls it) against its plain
    version, timed on a CUDA graph cycling ``K5_CACHES`` caches, with its
    byte bound."""
    g = torch.Generator(device="cuda").manual_seed(12)
    S, H, TOT, D = SLO_BATCH, 12, 704, 64
    q = torch.randn(S, H, D, device="cuda", generator=g)
    caches = k5_caches(torch, kv_quant, g, S, H, TOT, D, "int8", K5_CACHES)
    pc = torch.full((S,), TOT - 1, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(D)
    out = quant_attention.dequant_decode(q, *caches[0], pc, scale, 1024, 1)
    ref = quant_attention._decode_plain(q, *caches[0], pc, scale)
    torch.cuda.synchronize()
    err = k5_error(torch, out, ref)
    tol = 1e-5 * max(ref.abs().max().item(), 1.0)
    check(math.isfinite(err) and err <= tol,
          f"K5 at the batched prefill shape: err {err} (tol {tol})")
    turn = [0]

    def cycled(fn, *extra):
        def call():
            turn[0] += 1
            return fn(q, *caches[turn[0] % K5_CACHES], pc, scale, *extra)
        return call

    ms = graph_ms(torch, cycled(quant_attention.dequant_decode, 1024, 1),
                  10 * K5_CACHES)
    plain_ms = graph_ms(torch, cycled(quant_attention._decode_plain),
                        2 * K5_CACHES, reps=1)
    nbytes, rows = k5_bytes(pc, H, TOT, D, q)
    bound_ms, bound_by = _bound(4.0 * rows * D, nbytes, "float32")
    C = quant_attention._card_chunk("cuda", 1, H, 1024, D)
    print(f"K5 at the batched prefill shape S{S} H{H} TOT{TOT} D{D} C{C} "
          f"(span 1024, planned for one slot), pc all {TOT - 1}: "
          f"max_abs_err {err:.3e} (tol {tol:.3e}); kernel {ms:.5f} ms "
          f"(graph), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes} bytes)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def in_order(names, want):
    """Whether ``want`` is a subsequence of ``names``."""
    it = iter(names)
    return all(any(n == w for n in it) for w in want)


def handoff_leg(torch, serving, model, quant, k, ref, timeline=False):
    """``spec_prompts(torch, 4)`` (128 new each, one sampled) through
    ``ServingEngine(slots=8, quant=quant, spec=k)``, drained once a few
    decode turns have run and one request is in the middle of its
    prefill, then adopted into a fresh engine: every request's tokens
    must equal ``ref`` (an undisturbed engine's), with zero drops."""
    from mxtpu_torch.observability import tracer
    kw = dict(slots=8, quant=quant, spec=serving.SpecConfig(k=k)
              if k else None, prefix_cache_mb=64)
    sp = serving.SamplingParams(temperature=0.8, top_k=40, seed=1234)
    if timeline:
        tracer.reset()
        tracer.start()
    eng = serving.ServingEngine(model, **kw).start()
    reqs = [eng.submit(p, 128, sampling=sp if i == SPEC_SAMPLED else None)
            for i, p in enumerate(spec_prompts(torch, 4))]
    t0 = time.monotonic()
    while not (eng.stats().get("decode_steps", 0) >= 3
               and eng._pf is not None and eng._pf["t"] > 0):
        check(time.monotonic() - t0 < 600, "no moment with decode turns "
              "run and a request mid-prefill")
        time.sleep(0.001)
    t1 = time.perf_counter()
    h = eng.drain()
    drain_ms = (time.perf_counter() - t1) * 1e3
    eng2 = serving.ServingEngine(model, **kw)
    t1 = time.perf_counter()
    eng2.adopt(h)
    adopt_ms = (time.perf_counter() - t1) * 1e3
    outs = [r.result(timeout=900) for r in reqs]
    st2 = eng2.stats()
    eng2.stop()
    names = None
    if timeline:
        rid = h.entries[0]["req"].id
        names = [e["name"] for e in eng2.request_timeline(rid)]
        tracer.stop()
        tracer.reset()
    label = f"handoff {quant or 'float'}{f' spec={k}' if k else ''}"
    check(len(h.partial) == 1 and h.entries,
          f"{label}: {len(h.entries)} slot entries, {len(h.partial)} "
          f"mid-prefill")
    check(all(r.state == serving.DONE for r in reqs)
          and st2.get("cancelled", 0) == 0
          and st2.get("adopted") == h.in_flight == len(reqs),
          f"{label}: a request dropped: {[r.state for r in reqs]}")
    differ = [i for i, (a, b) in enumerate(zip(outs, ref)) if a != b]
    check(not differ, f"{label}: requests {differ} differ from the "
          f"undisturbed engine's tokens")
    drafts = sum(e.get("dlen") or 0 for e in h.entries)
    print(f"  {label}: drained {len(h.entries)} decoding, {len(h.partial)}"
          f" mid-prefill (cursor {h.partial[0]['t']} of "
          f"{h.partial[0]['PB']}), {len(h.pending)} queued"
          f"{f', {drafts} drafted tokens in flight' if k else ''}; drain "
          f"{drain_ms:.1f} ms, adopt {adopt_ms:.1f} ms, handoff "
          f"{h.nbytes} bytes; the adopting engine captured "
          f"{st2.get('programs_captured', 0)} programs in "
          f"{st2.get('capture_ms_total', 0):.1f} ms; tokens equal the "
          f"undisturbed engine's, zero drops", flush=True)
    return names


def slo_refs(torch, model, serving, quant_attention, step_cache):
    """The undisturbed engines' tokens of phase 5c's first burst: its
    spec-less ``int8_kv`` and float legs (when 5e runs without 5c)."""
    bursts = [spec_prompts(torch, 4)]
    return {q: spec_leg(torch, model, serving, quant_attention, step_cache,
                        q, 0, bursts)[0][0]["toks"]
            for q in ("int8_kv", None)}


def phase_slo(torch, model, serving, quant_attention, step_cache, counts,
              smi, refs=None):
    """The SLO control plane on the card (phase 5e): the two-tenant burst
    through a sched engine with batched prefill, against a plain engine;
    three drain/adopt handoffs against undisturbed engines (``refs``:
    phase 5c's spec-less first-burst tokens, run here when None); one
    adopted request's timeline. Returns the K5 record of the batched
    prefill path."""
    from mxtpu_torch import profiler
    from mxtpu_torch.quant import kv_quant
    L = len(model.blocks)
    if refs is None:
        refs = slo_refs(torch, model, serving, quant_attention, step_cache)
    trace = slo_trace()
    profiler.reset_serving_stats()
    profiler.reset_feed_stats()
    stalls0 = profiler.get_resilience_stats()["watchdog_stalls"]
    traces0 = program_traces(step_cache)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    counts(0)
    with serving.ServingEngine(model, slots=8, quant="int8_kv", sched=True,
                               prefill_batch=SLO_BATCH,
                               stall_deadline_s=SLO_STALL_S,
                               engine_id="e0") as eng:
        reqs, active = slo_burst(torch, serving, eng, trace)
        launches = quant_attention.dequant_decode.launches
        st = eng.stats()
        beats = eng._wd.beats()
        keys = len(eng._prefill_fns)
        chunk = eng.chunk
        chunk_ms = batched_chunk_ms(torch, eng)
    wall = time.monotonic() - t0
    feed = profiler.get_feed_stats()
    tenants = profiler.get_serving_stats().get("tenants", {})
    traces = {k_: v - traces0[k_]
              for k_, v in program_traces(step_cache).items()}
    with serving.ServingEngine(model, slots=8, quant="int8_kv",
                               queue_depth=32) as eng:
        plain = [eng.submit(p, n) for p, n, _, _ in
                 trace["pilot"] + trace["low"] + trace["high"]]
        plain = [r.result(timeout=900) for r in plain]
    differ = [i for i, (r, t) in enumerate(zip(reqs, plain))
              if r.tokens() != t]
    check(not differ, f"SLO burst: requests {differ} differ from the plain "
          f"engine's tokens")
    check(st.get("preempted", 0) >= 1 and st.get("resumed", 0) >= 1,
          f"SLO burst: preempted {st.get('preempted')}, resumed "
          f"{st.get('resumed')}")
    check(st.get("prefill_groups", 0) >= 1, "SLO burst: no batched prefill "
          "group of 2 or more prompts")
    check(st.get("prefill_replays") == st.get("prefill_chunks")
          and st.get("batched_replays") == st.get("batched_chunks")
          and st.get("decode_replays") == st.get("decode_steps"),
          f"SLO burst: a chunk ran outside a replay: {st}")
    captured = st.get("programs_captured", 0)
    check(captured == sum(traces.values())
          and traces["serving_prefill"] == keys,
          f"SLO burst: {captured} captures, traces {traces}, {keys} prefill "
          f"keys: not one capture per key")
    positions = st.get("prefill_positions", 0) \
        + st.get("batched_positions", 0) + st["decode_steps"] * chunk
    check(launches == L * (positions + captured),
          f"SLO burst: {launches} dequant_decode launches, not {L} x "
          f"({positions} positions + {captured} warm-up steps)")
    dispatches = st.get("prefill_chunks", 0) \
        + st.get("batched_chunks", 0) + st["decode_steps"]
    stalls = profiler.get_resilience_stats()["watchdog_stalls"] - stalls0
    check(beats >= dispatches and stalls == 0,
          f"SLO burst: {beats} serving beats for {dispatches} dispatches, "
          f"{stalls} stalls")
    check(feed["transfer_count"] == len(reqs),
          f"SLO burst: {feed['transfer_count']} feed transfers for "
          f"{len(reqs)} requests")
    print(f"SLO burst (phase 5e) on {smi}: ServingEngine(slots=8, int8_kv, "
          f"sched, prefill_batch={SLO_BATCH}, stall_deadline_s="
          f"{SLO_STALL_S}, engine_id=e0): a pilot ({SLO_PILOT[0]} tokens, "
          f"{SLO_PILOT[1]} new), {SLO_N} batch-tier requests (prompts "
          f"{sorted(len(p) for p, *_ in trace['low'])}, 128 new), then "
          f"{SLO_N} interactive ({sorted(len(p) for p, *_ in trace['high'])}"
          f", 64 new) once the first group decoded ({active} slots "
          f"active): {wall:.2f} s; "
          f"preempted {st.get('preempted')}, resumed {st.get('resumed')}, "
          f"shed {st.get('shed', 0)}; batched prefill groups "
          f"{st.get('prefill_groups')} ({st.get('batched_chunks')} chunks, "
          f"{st.get('batched_positions')} positions), B=1 prefill chunks "
          f"{st.get('prefill_chunks')} ({st.get('prefill_positions')} "
          f"positions), decode chunks {st['decode_steps']}; every chunk a "
          f"replay; {captured} captures ({traces}) in "
          f"{st.get('capture_ms_total', 0):.1f} ms, one a key; K5 "
          f"launches {launches} = {L} x ({positions} + {captured}); "
          f"serving beats {beats} for {dispatches} dispatches, no stall; "
          f"feed transfers {feed['transfer_count']} "
          f"({feed['transfer_bytes']} bytes, {feed['transfer_ms_total']:.2f}"
          f" ms of host time); every request's tokens equal the plain "
          f"engine's", flush=True)
    for key in ("low", "high"):
        part = [r for r in reqs if r.tenant == SLO[key][0]]
        print("  " + tenant_line(part, tenants.get(SLO[key][0], {})),
              flush=True)
    (bk, b_ms), (pk, p_ms) = chunk_ms
    print(f"  what batching costs: a replay of the batched chunk {bk} "
          f"{b_ms:.3f} ms ({SLO_BATCH} rows, float products one row at a "
          f"time) against the B=1 chunk {pk} {p_ms:.3f} ms: "
          f"{SLO_BATCH * p_ms / b_ms:.2f}x the B=1 chunk's positions a "
          f"second", flush=True)
    print(f"handoffs (phase 5e), 8 requests of phase 5c's first burst on "
          f"{smi}:", flush=True)
    names = handoff_leg(torch, serving, model, "int8_kv", 0,
                        refs["int8_kv"], timeline=True)
    handoff_leg(torch, serving, model, None, 0, refs[None])
    handoff_leg(torch, serving, model, "int8_kv", SPEC_K, refs["int8_kv"])
    want = ["serving/submit", "serving/admit", "serving/prefill_chunk",
            "serving/decode", "serving/drain_freeze", "serving/adopt_resume",
            "serving/decode", "serving/retire"]
    check(in_order(names, want), f"timeline of an adopted request: {names}")
    runs = [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]]
    print(f"  timeline of an adopted request (int8_kv leg, {len(names)} "
          f"events; repeats folded): {' -> '.join(runs)}", flush=True)
    rec = k5_batched_record(torch, quant_attention, kv_quant)
    return dict(launches=launches, launches_in_replays=L * positions, **rec)


def phase_int8_products(torch, serve, smi):
    """``serve._int8_matmul`` at the step's shapes, M in {1, 8, 40} x
    (768 -> 768, 768 -> 3072, 3072 -> 768, 768 -> 50257 padded to
    50264): bit-equal to the exact product (int32 sums checked in
    float64), timed on a CUDA graph against ``F.linear`` in f32 at the
    same shapes; and whether ``F.linear`` over 40 flattened rows gives
    each 8-row block's bits (the verify step's float products)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(12)
    from mxtpu_torch.quant import kv_quant
    lines = []
    for K, N in ((768, 768), (768, 3072), (3072, 768), (768, 50257)):
        w = torch.randn(N, K, device="cuda", generator=g) * 0.02
        b = torch.zeros(N, device="cuda")
        wq, ws = serve._pad_rows(*serve._quantize_weight(w))
        for M in (1, 8, 40):
            h = torch.randn(M, K, device="cuda", generator=g)
            got = serve._int8_matmul(h, wq, ws)
            hq, hs = kv_quant.quantize_rows(h, "int8")
            exact = (hq.double() @ wq.double().t()).float()
            check(torch.equal(got, exact * hs[:, None] * ws[None, :]),
                  f"_int8_matmul M{M} {K}->{N}: not the exact int32 sum")
            ms = graph_ms(torch, lambda: serve._int8_matmul(h, wq, ws), 20)
            f_ms = graph_ms(torch, lambda: F.linear(h, w, b), 20)
            lines.append(f"  M={M} {K}->{N}: _int8_matmul {ms:.4f} ms, "
                         f"F.linear f32 {f_ms:.4f} ms ({f_ms / ms:.2f}x)")
        h = torch.randn(40, K, device="cuda", generator=g)
        flat = F.linear(h, w, b)
        same = [torch.equal(flat[j:j + 8], F.linear(h[j:j + 8].contiguous(),
                                                     w, b))
                for j in range(0, 40, 8)]
        lines.append(f"  F.linear f32 over 40 rows vs 8-row blocks, "
                     f"{K}->{N}: blocks bit-equal {same}")
    print(f"int8 products (``_int8_matmul``: row quantization, cuBLASLt "
          f"int8 x int8 -> int32 via torch._int_mm, rescale; exact) on "
          f"{smi}, device time on a CUDA graph:", flush=True)
    for line in lines:
        print(line, flush=True)


def phase_verify_card_vs_cpu(torch, lm, serving, quant_attention, smi):
    """One verify dispatch of a base-width, 2-layer ``int8_kv,int8_w``
    model (S 8, TOT 832, k 4; one slot clipped at TOT - 1) on the card (a
    replay of the captured program) and on the CPU, over one cache that
    829 decode steps of random tokens filled on the card: outs, lives,
    tok, p equal; the verify step's logits on the card against the CPU
    within ``VERIFY_LOGITS_TOL``; every K5 call inside the replay against
    the plain version at 1e-5 x max(|ref|, 1), and K5 timed at those
    calls' shapes. Returns K5's record at the verify shape."""
    import numpy as np
    from mxtpu_torch.quant import kv_quant, serve
    kv = serving.kv
    S, TOT, k = 8, 832, SPEC_K
    K1 = k + 1
    cpu = lm.transformer_lm("base", vocab_size=50257, num_layers=2,
                            device="cpu", seed=13)
    gpu = lm.transformer_lm("base", vocab_size=50257, num_layers=2, seed=14)
    gpu.load_state_dict(cpu.state_dict())
    L, H, D = kv.cache_dims(cpu)
    spec = serve.parse_quant("int8_kv,int8_w")
    rs = np.random.RandomState(16)
    p = rs.randint(0, TOT - 40, S)
    p[0], p[1] = 0, TOT - 3                  # slot 1 clipped from j = 2
    state = dict(tok=rs.randint(0, 50257, S), p=p,
                 active=np.ones(S, bool), limit=p + 5,
                 temp=np.zeros(S, np.float32), topk=np.zeros(S, np.int64),
                 seed=np.zeros(S, np.int64),
                 draft=rs.randint(0, 50257, (S, k)),
                 dlen=np.full(S, k))
    state["limit"][1] = TOT - 1
    with torch.inference_mode():
        filled = kv.empty_cache(gpu, S, TOT, quant=spec, device="cuda")
        step = serve.build_step(gpu, S, TOT, spec)
        pg_ = serve.quantize_lm(gpu, spec)
        hist = torch.from_numpy(rs.randint(0, 50257, (TOT - 3, S))).cuda()
        for t in range(TOT - 3):
            step(pg_, filled, hist[t], torch.full((S,), t, device="cuda"))
        data, scale = filled.data.cpu(), filled.scale.cpu()
        del filled

    def caches(dev):
        return kv_quant.QuantKV(data.clone().to(dev), scale.clone().to(dev),
                                "int8")

    with torch.inference_mode():
        pc_ = serve.quantize_lm(cpu, spec)
        # drafts: the CPU model's own first two tokens a slot, then others
        vstep_c = serve.build_verify_step(cpu, S, TOT, K1, spec)
        feeds = torch.from_numpy(np.concatenate(
            [state["tok"][:, None], state["draft"]], 1))
        for j in range(2):
            _, lg = vstep_c(pc_, caches("cpu"), feeds, torch.from_numpy(p))
            feeds[:, j + 1] = lg[:, j].argmax(-1)
        state["draft"] = feeds[:, 1:].numpy().copy()
        _, lc = vstep_c(pc_, caches("cpu"), feeds, torch.from_numpy(p))
        nudged = dict(pc_, pos=pc_["pos"] * (1 + 1e-6))
        _, ln_ = vstep_c(nudged, caches("cpu"), feeds, torch.from_numpy(p))
        nrows = (ln_ - lc).abs().amax(-1)
        vstep_g = serve.build_verify_step(gpu, S, TOT, K1, spec)
        lgpu, codes_g = with_codes(kv_quant, lambda: vstep_g(
            pg_, caches("cuda"), feeds.cuda(), torch.from_numpy(p).cuda()))
        lc2, codes_c = with_codes(kv_quant, lambda: vstep_c(
            pc_, caches("cpu"), feeds, torch.from_numpy(p)))
        check(torch.equal(lc2, lc), "the CPU verify step is not repeatable")
        rows = (lgpu.cpu() - lc).abs().amax(-1)          # (S, K1)
        lerr, close = rows.max().item(), (rows <= 1e-4).float().mean().item()
        check(lerr <= VERIFY_LOGITS_TOL[0] and close >= VERIFY_LOGITS_TOL[1],
              f"verify logits card vs CPU: max diff {lerr}, share of rows "
              f"within 1e-4 {close} (tol {VERIFY_LOGITS_TOL})")
        moved, roots, root_step, root_off = code_divergence(
            torch, codes_c, codes_g, S, K1)
        agree = ~moved
        check(roots == 0 or (root_step == 1
                             and root_off <= CODE_BOUNDARY),
              f"verify card vs CPU: {roots} rows part at an int8 code "
              f"{root_step} steps away, {root_off:.3e} from a half step "
              f"(at most one step, within {CODE_BOUNDARY})")
        eq_err = rows[agree].max().item() if agree.any() else 0.0
        moved_err = rows[moved].max().item() if moved.any() else 0.0
        check(eq_err <= 1e-4, f"verify card vs CPU: rows whose int8 codes "
              f"all agree differ by {eq_err} (tol 1e-4); rows "
              f"{rows.tolist()}, rows moved by a code {moved.tolist()}")
        ref = kv.build_verify(cpu, pc_, caches("cpu"), S, TOT, k,
                              quant=spec)(*state.values())
        # the card: the captured program, its K5 calls recorded by clones
        # captured into the graph beside them
        seen = []
        real = quant_attention.dequant_attention_decode

        def recorded(q, kd, ks, vd, vs, pc, **kw):
            out = real(q, kd, ks, vd, vs, pc, **kw)
            seen.append((q.clone(), pc.clone(), out.clone()))
            return out

        gc = caches("cuda")
        prog = kv.build_verify(gpu, pg_, gc, S, TOT, k, quant=spec,
                               pool=torch.cuda.graph_pool_handle())
        quant_attention.dequant_attention_decode = recorded
        try:
            got = prog(*state.values())
        finally:
            quant_attention.dequant_attention_decode = real
        torch.cuda.synchronize()
    check(prog.replays == 1 and len(seen) == 2 * L * K1,
          f"verify program: {prog.replays} replays, {len(seen)} K5 calls "
          f"recorded (warm-up and capture: {2 * L * K1})")
    for name, a, b in zip(("tok", "p", "outs", "lives"), got, ref):
        if not np.array_equal(a, b):
            top = lc.topk(2, dim=-1).values
            margin = (top[..., 0] - top[..., 1]).numpy()
            raise SmokeFailure(
                f"verify card vs CPU: {name} differ: {a.tolist()} vs "
                f"{b.tolist()}; CPU top-2 logit margins (slot, position) "
                f"{np.round(margin, 4).tolist()}, logits diff by row "
                f"{np.round(rows.numpy(), 4).tolist()}")
    scale_ = 1.0 / math.sqrt(D)
    err = 0.0
    for n, (q, pc, out) in enumerate(seen[L * K1:]):
        i = n // K1
        refo = quant_attention._decode_plain(
            q, gc.data[i, 0], gc.scale[i, 0], gc.data[i, 1],
            gc.scale[i, 1], pc, scale_)
        e = k5_error(torch, out, refo)
        tol = 1e-5 * max(refo.abs().max().item(), 1.0)
        check(math.isfinite(e) and e <= tol, f"K5 inside the verify "
              f"replay, layer {i} position {n % K1}: err {e} (tol {tol})")
        err = max(err, e)
    # K5 at the verify calls' shapes: layer 0's K1 calls, cycled
    calls = seen[L * K1:L * K1 + K1]
    cache0 = (gc.data[0, 0], gc.scale[0, 0], gc.data[0, 1], gc.scale[0, 1])
    turn = [0]

    def cycled(fn):
        def call():
            turn[0] += 1
            q, pc, _ = calls[turn[0] % K1]
            return fn(q, *cache0, pc, scale_)
        return call

    ms = graph_ms(torch, cycled(quant_attention.dequant_decode), 10 * K1)
    plain_ms = graph_ms(torch, cycled(quant_attention._decode_plain), K1,
                        reps=1)
    nbytes = rows = 0
    for q, pc, _ in calls:
        nb, r = k5_bytes(pc, H, TOT, D, q)
        nbytes, rows = nbytes + nb, rows + r
    bound_ms, bound_by = _bound(4.0 * rows * D, nbytes, "float32")
    n_ok = int(got[3].sum())
    print(f"verify card vs CPU (base width, {L} layers, int8_kv,int8_w, S "
          f"{S} TOT {TOT} k {k}, one slot clipped at TOT - 1) on {smi}: "
          f"tok, p, outs, lives equal ({n_ok} tokens emitted); logits max "
          f"diff {lerr:.3e}, {close:.3f} of the (slot, position) rows within"
          f" 1e-4 (tol {VERIFY_LOGITS_TOL}); per code, over {len(codes_c)}"
          f" row quantizations (activations and K/V rows): "
          f"{int(agree.sum())} rows whose codes all agree, max diff "
          f"{eq_err:.3e} (tol 1e-4); {int((~agree).sum())} rows downstream"
          f" of {roots} root differences, each one step at a value "
          f"{root_off:.2e} from a half step at most (tol {CODE_BOUNDARY}),"
          f" max diff {moved_err:.3e} (on the CPU alone, the position "
          f"table scaled by 1 + 1e-6 moves the logits by up to "
          f"{nrows.max().item():.3e}, {(nrows <= 1e-4).float().mean():.3f} "
          f"of the rows within 1e-4); K5 inside the replay, {L * K1} "
          f"calls: max_abs_err {err:.3e} (tol 1e-5 x max(|ref|, 1)); K5 at "
          f"these calls' shapes {ms:.5f} ms a call (graph), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms / K1:.5f} ms ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms / K1, bound_by=bound_by, library_ms=None)


def with_codes(kv_quant, fn):
    """``fn()``'s logits and every row quantization it ran
    (``kv_quant.quantize_rows``: the activation rows of each int8 product
    and the K/V rows it appends), in call order, on the host: (input,
    codes, scales) a call."""
    real = kv_quant.quantize_rows
    seen = []

    def rec(x, mode="int8"):
        q, s_ = real(x, mode)
        seen.append((x.float().cpu(), q.cpu(), s_.cpu()))
        return q, s_

    kv_quant.quantize_rows = rec
    try:
        _, logits = fn()
    finally:
        kv_quant.quantize_rows = real
    return logits.cpu(), seen


# a code that differs between the card and the CPU before anything else
# of its row does must come from a value at a rounding boundary: within
# this much of a half step on the CPU's side
CODE_BOUNDARY = 1e-3


def code_divergence(torch, codes_c, codes_g, S, K1):
    """Where the card's int8 codes part from the CPU's, row by row.

    Calls run in the verify step's order: per layer the q, k, v products
    (``(S * K1, in)`` activation rows), the K/V rows appended (``(S, H,
    D)``, K then V, position by position), then the out and FFN products;
    then the head. Row (slot, position j) attends to positions 0..j, so a
    difference at (s, j') reaches every (s, j >= j'). A *root* difference
    is one in a row nothing before it had moved: it must be one step, at
    a value that sits within ``CODE_BOUNDARY`` of a half step on the CPU
    (f32 reassociation rounding it the other way); what follows a root
    may differ by more. Returns (moved (S, K1) bool: rows downstream of a
    root, roots, the largest root step, the farthest root value from a
    half step)."""
    check(len(codes_c) == len(codes_g), "verify card vs CPU: other "
          f"quantizations ran ({len(codes_c)} vs {len(codes_g)})")
    moved = torch.zeros(S, K1, dtype=torch.bool)
    roots, worst_step, worst_off = 0, 0, 0.0
    kv_calls = 0
    for (x, qc, sc), (_, qg, _) in zip(codes_c, codes_g):
        d = (qc.to(torch.int32) - qg.to(torch.int32)).abs()
        v = x / sc[..., None]
        off = ((v - v.floor()) - 0.5).abs()
        if d.dim() == 2 and d.shape[0] == S * K1:
            d, off = d.view(S, K1, -1), off.view(S, K1, -1)
        elif d.dim() == 3 and d.shape[0] == S:
            j = (kv_calls // 2) % K1
            kv_calls += 1
            full = torch.zeros((S, K1) + d.shape[1:], dtype=d.dtype)
            full[:, j] = d
            d = full.reshape(S, K1, -1)
            full = torch.zeros((S, K1) + off.shape[1:])
            full[:, j] = off
            off = full.reshape(S, K1, -1)
        else:
            raise SmokeFailure(f"unexpected quantization {tuple(d.shape)}")
        own = d.amax(-1) > 0
        new = own & ~moved
        if new.any():
            roots += int(new.sum())
            worst_step = max(worst_step, int(d[new].max()))
            worst_off = max(worst_off, float(off[new][d[new] > 0].max()))
        moved = torch.cummax((moved | own).to(torch.int8), dim=1).values \
            .bool()
    return moved, roots, worst_step, worst_off


def drive_programs(torch, kv, model, spec, reqs, replay):
    """A short serving trace straight through the chunk programs, as the
    engine runs them: each request prefills through a PB = 64 page in two
    32-position chunks (the first with every cursor in K5's chunk 0 of the
    split page), is merged into its slot of an (8 slots, TOT = 128) cache,
    and the batch then decodes three 8-step chunks with the six other
    slots empty (cursors at 0). ``replay``: each call replays the
    program's graph; else each runs its ``body`` with a host sync made an
    error. Returns the tokens, the cache, the page and the programs."""
    import numpy as np
    dev = torch.device("cuda")
    caches = kv.empty_cache(model, 8, 128, quant=spec, device=dev)
    page = kv.empty_page(model, 64, quant=spec, device=dev)
    pool = torch.cuda.graph_pool_handle()
    params = model._gen_params()
    pre = kv.build_prefill_chunk(model, params, page, 64, 32, spec, pool)
    dec = kv.build_decode(model, params, caches, 8, 128, 8, spec, pool)

    def call(prog, *args):
        if replay:
            return prog(*args)
        prog.stage(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.body()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return prog.unpack(prog.out.cpu().numpy())

    z = lambda dt=np.int64: np.zeros(8, dt)          # noqa: E731
    tok, p, active, limit, topk, seed = z(), z(), z(bool), z(), z(), z()
    temp = z(np.float32)
    tokens = []
    for slot, (prompt, tm, k, sd) in enumerate(reqs):
        kv.reset_page(page)
        padded = np.zeros(64, np.int64)
        padded[:len(prompt)] = prompt
        prev = 0
        for start in (0, 32):
            outs = call(pre, padded, len(prompt), start, prev, tm, k, sd)
            prev = int(outs[-1])
            tokens.append(outs.tolist())
        kv.merge_page(caches, page, slot)
        tok[slot], p[slot], limit[slot], active[slot] = prev, 64, 100, True
        temp[slot], topk[slot], seed[slot] = tm, k, sd
    for _ in range(3):
        tok, p, toks, lives = call(dec, tok, p, active, limit, temp, topk,
                                   seed)
        tokens.append(np.where(lives, toks, -1).tolist())
    torch.cuda.synchronize()
    return tokens, caches, page, (pre, dec)


def phase_programs(torch, lm, serving, quant_attention, counts):
    """The serving programs on the card: base width, 2 layers, int8 KV, a
    greedy and a sampled request (``drive_programs``) once through graph
    replays and once through each program's body. Tokens must be equal
    exactly, and the final cache's and page's bytes and scales bit-equal;
    every chunk of the replayed run must be a replay, and K5's launches
    there exactly L x (steps replayed + one warm-up step a program)."""
    from mxtpu_torch.quant import kv_quant
    from mxtpu_torch.quant.serve import parse_quant
    kv = serving.kv
    spec = parse_quant("int8_kv")
    model = lm.transformer_lm("base", vocab_size=50257, num_layers=2, seed=7)
    g = torch.Generator().manual_seed(8)
    reqs = [(torch.randint(0, 50257, (n,), generator=g).tolist(), tm, k, sd)
            for n, tm, k, sd in ((40, 0.0, 0, 0), (50, 0.8, 40, 11))]
    L = len(model.blocks)
    with torch.inference_mode():
        counts(0)
        t0 = time.monotonic()
        got, caches, page, progs = drive_programs(torch, kv, model, spec,
                                                  reqs, True)
        replay_s = time.monotonic() - t0
        launches = quant_attention.dequant_decode.launches
        t0 = time.monotonic()
        ref, caches_ref, page_ref, _ = drive_programs(torch, kv, model, spec,
                                                      reqs, False)
        eager_s = time.monotonic() - t0
    calls = [len(reqs) * 2, 3]
    check([prog.replays for prog in progs] == calls,
          f"replays {[prog.replays for prog in progs]}, calls {calls}: a "
          f"chunk ran outside a replay")
    steps = len(reqs) * 64 + 3 * 8
    check(launches == L * (steps + len(progs)),
          f"replayed run: {launches} dequant_decode launches, not {L} x "
          f"({steps} steps + {len(progs)} warm-up steps)")
    check(got == ref, f"graph-replayed tokens differ from the bodies': "
          f"{got} vs {ref}")
    for name, a, b in (("cache", caches, caches_ref),
                       ("page", page, page_ref)):
        check(torch.equal(kv_quant.raw(a.data), kv_quant.raw(b.data))
              and torch.equal(a.scale, b.scale),
              f"the {name}'s bytes or scales differ between replay and body")
    print(f"serving programs card parity (base width, {L} layers, int8 KV, "
          f"prefill PB 64 in 2 chunks of 32 then 3 decode chunks of 8 at "
          f"slots 8 TOT 128, one greedy and one sampled request): tokens "
          f"equal, cache and page bytes and scales bit-equal, replay "
          f"{replay_s:.2f} s (captures {sum(p.capture_ms for p in progs):.1f}"
          f" ms) vs bodies {eager_s:.2f} s; every chunk a replay; K5 "
          f"launches {launches} = {L} x ({steps} + {len(progs)}); the sampled "
          f"request's last prefill tokens {got[3][-8:]}", flush=True)


ROUTER_SHARED = (110, 180, 240, 340)   # lengths: buckets phase 5 captured


def router_prompts(torch, seed=7):
    """The router phase's 4 extra prompts: one shared 32-token first block
    (prefix affinity sends them to one replica), then their own tokens."""
    g = torch.Generator().manual_seed(seed)
    block = torch.randint(0, 50257, (32,), generator=g).tolist()
    return [block + torch.randint(0, 50257, (n - 32,), generator=g).tolist()
            for n in ROUTER_SHARED]


def wait_for(cond, what, timeout=600):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise SmokeFailure(f"router: {what} not within {timeout} s")
        time.sleep(0.002)


def slot_rows(eng, req, n):
    """The first ``n`` K/V positions of ``req``'s decode slot in ``eng``'s
    int8 cache, on the host: (codes, scales), each (L, 2, H, n, ...)."""
    slot = next(i for i, r in enumerate(eng._reqs) if r is req)
    c = eng._caches
    return (c.data[:, :, slot, :, :n].cpu(),
            c.scale[:, :, slot, :, :n].cpu())


def rows_differ(a, b, n0):
    """(prompt, emitted) counts of entries of ``a`` that differ from
    ``b`` along the position axis (3), split at ``n0``."""
    bad = a != b
    return int(bad[:, :, :, :n0].sum()), int(bad[:, :, :, n0:].sum())


def phase_router(torch, model, serving, quant_attention, step_cache, counts,
                 refs, smi):
    """Two ``base`` engines on the card behind ``Router.local`` (phase 5's
    model, ``int8_kv``, slots 8, ``sched``): phase 5's 8 prompts and 4
    sharing a first block, 128 new tokens each. Once both replicas decode,
    the exporter is scraped once (port 0) and the busier replica is
    removed (its requests re-routed as continuations); then the survivor
    is rebalanced (drain, a fresh engine, adopt) while it is mid-flight.
    Every request's tokens must equal its plain engine reference
    (``refs``: phase 5's engine), with zero drops; K5's launches must equal
    L x (prefill positions + decode chunks x chunk + captures) summed over
    the three engines, each with K5 replays of its own. Returns the K5
    record of the path."""
    from mxtpu_torch import profiler
    from mxtpu_torch.observability import exporter
    import urllib.request
    prompts = serving_prompts(torch) + router_prompts(torch)
    check(len(refs) == len(prompts), f"{len(refs)} references for "
          f"{len(prompts)} prompts")
    L = len(model.blocks)
    made = []

    def factory(rid):
        eng = serving.ServingEngine(model, slots=8, quant="int8_kv",
                                    sched=True, engine_id=rid)
        made.append(eng)
        return eng

    profiler.reset_router_stats()
    torch.cuda.synchronize()
    counts(0)
    t0 = time.monotonic()
    router = serving.Router.local(factory, 2).start()
    try:
        hs = [router.submit(p, 128) for p in prompts]
        homes = {rid: [i for i, h in enumerate(hs)
                       if any(r is h for r in book.values())]
                 for rid, book in router._inflight.items()}
        # both replicas decoding, and on each up to 3 of its requests past
        # their first decode chunk, so the removal moves continuations
        # that carry decoded tokens
        wait_for(lambda: all(
            sum(len(hs[i].tokens()) > 8 for i in idx) >= min(3, len(idx))
            for idx in homes.values()), "both replicas decoding")
        ex = exporter.start(port=0)
        try:
            base = f"http://127.0.0.1:{ex.port}"
            text = urllib.request.urlopen(base + "/metrics",
                                          timeout=60).read().decode()
            snap = json.loads(urllib.request.urlopen(
                base + "/json", timeout=60).read())
        finally:
            exporter.stop()
        for rid in ("replica0", "replica1"):
            check(f'mxtpu_engine_in_flight{{engine="{rid}"}}' in text,
                  f"exporter: no series labelled {rid}")
        check(f"mxtpu_router_submitted {len(prompts)}" in text
              and "mxtpu_router_requests_dropped 0" in text,
              "exporter: router counters missing")
        check(sorted(snap["engines"]) == ["replica0", "replica1"]
              and snap["router"]["submitted"] == len(prompts),
              f"exporter /json: engines {sorted(snap['engines'])}, router "
              f"{snap['router']}")
        first = [h._segment()[0] for h in hs]
        books = {rid: sum(0 if h.done() else 1 for h in book.values())
                 for rid, book in router._inflight.items()}
        victim = max(books, key=books.get)
        survivor = next(r for r in router.replica_ids if r != victim)
        veng = router._replicas[victim].engine
        t1 = time.perf_counter()
        moved = router.remove_replica(victim)
        remove_ms = (time.perf_counter() - t1) * 1e3
        conts = [i for i, h in enumerate(hs)
                 if h._segment()[0] is not first[i]]
        # the victim's rows of each continuation that held a decode slot:
        # every position before its last emitted token
        slotted = [i for i in conts if any(r is first[i] for r in veng._reqs)
                   and first[i].tokens()]
        want = {i: slot_rows(veng, first[i], len(prompts[i])
                             + len(first[i].tokens()) - 1) for i in slotted}
        seng = router._replicas[survivor].engine

        def in_decode(i):
            seg = hs[i]._segment()[0]
            return seg.done() or (seg.tokens() and any(
                r is seg for r in seng._reqs))

        wait_for(lambda: all(in_decode(i) for i in slotted),
                 "every continuation's first new token")
        got = {i: slot_rows(seng, hs[i]._segment()[0], want[i][0].shape[3])
               for i in slotted if not hs[i]._segment()[0].done()}
        before = router._replicas[survivor].engine
        mid = sum(not h.done() for h in hs)
        t1 = time.perf_counter()
        router.rebalance(survivor)
        rebalance_ms = (time.perf_counter() - t1) * 1e3
        outs = [h.result(timeout=900) for h in hs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = quant_attention.dequant_decode.launches
        segs = [h._segment()[0] for h in hs]
    finally:
        router.stop()
    stats = profiler.get_router_stats()
    for i, (a, b) in enumerate(zip(outs, refs)):
        if a != b:
            j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            raise SmokeFailure(
                f"router request {i} ({len(prompts[i])} tokens, "
                f"{'re-routed' if i in conts else 'not re-routed'}): tokens "
                f"differ from the plain engine's at new token {j} of "
                f"{len(b)}")
    # the continuation's rows are the victim's, bit for bit: codes and
    # scales, prompt and emitted rows apart
    diffs = {i: rows_differ(got[i][0], want[i][0], len(prompts[i]))
             + rows_differ(got[i][1], want[i][1], len(prompts[i]))
             for i in got}
    n_codes = sum(w[0].numel() for w in want.values())
    decoded = [i for i in got
               if want[i][0].shape[3] > -(-len(prompts[i]) // 32) * 32]
    check(decoded, f"router: no compared continuation {sorted(got)} has "
          f"rows that decode wrote")
    check(got and all(d == (0, 0, 0, 0) for d in diffs.values()),
          f"router: continuation rows differ from the removed replica's "
          f"(prompt codes, emitted codes, prompt scales, emitted scales) "
          f"{diffs}" + ("" if got else ": no continuation held a slot"))
    check(stats["requests_dropped"] == 0 and moved >= 1
          and stats["requests_rebalanced"] == moved == len(conts)
          and stats["replicas_removed"] == 1 and stats["rebalanced"] == 1
          and stats["replicas"] == 1,
          f"router stats {stats}, moved {moved}, continuations {conts}")
    st = {e.engine_id + ("'" if e is not made[0] and e is not made[1]
                         else ""): e.stats() for e in made}
    for name, s in st.items():
        check(s.get("prefill_replays", 0) == s.get("prefill_chunks", 0)
              and s.get("decode_replays", 0) == s.get("decode_steps", 0),
              f"{name}: a chunk ran outside a graph replay: {s}")
    check(all(s.get("decode_replays", 0) > 0 for s in st.values()),
          f"an engine replayed no decode chunk (K5 inside): "
          f"{ {n: s.get('decode_replays') for n, s in st.items()} }")
    chunk = made[0].chunk
    steps = sum(s.get("prefill_positions", 0)
                + s.get("decode_steps", 0) * chunk for s in st.values())
    captured = sum(s.get("programs_captured", 0) for s in st.values())
    check(launches == L * (steps + captured),
          f"router: {launches} dequant_decode launches, not {L} x ({steps} "
          f"steps replayed + {captured} warm-ups) over the 3 engines")
    tps = len(prompts) * 128 / wall
    ttft = [(segs[i].t_first_token - segs[i].t_submit) * 1e3 for i in conts]
    print(f"router, 2 replicas of base int8_kv slots 8 sched on one card: "
          f"{len(prompts)} requests x 128 tokens in {wall:.2f} s = "
          f"{tps:.1f} tokens/s, captures included; homes {homes}; every "
          f"request equals the plain engine's; remove_replica({victim}) "
          f"{remove_ms:.1f} ms (drain and re-route), moved {moved} "
          f"(requests {conts}, emitted before the move "
          f"{[len(hs[i]._prefix_tokens) for i in conts]}); continuation "
          f"TTFT ms {[round(x, 1) for x in ttft]}; rebalance({survivor}) "
          f"with {mid} requests in flight {rebalance_ms:.1f} ms (drain, a "
          f"fresh engine, adopt); router stats {stats}; {smi}", flush=True)
    for name, s in st.items():
        print(f"  engine {name}: stream {s.get('stream')}, captures "
              f"{s.get('programs_captured', 0)} in "
              f"{s.get('capture_ms_total', 0):.1f} ms, prefill positions "
              f"{s.get('prefill_positions', 0)}, decode chunks "
              f"{s.get('decode_steps', 0)}, completed "
              f"{s.get('completed', 0)}, drained {s.get('drained', 0)}, "
              f"adopted {s.get('adopted', 0)}", flush=True)
    print(f"  K5 launches {launches} = {L} x ({steps} steps replayed + "
          f"{captured} warm-ups) over the 3 engines", flush=True)
    print(f"  continuation rows against the removed replica's, requests "
          f"{sorted(got)} ({n_codes} int8 codes; decode wrote rows of "
          f"{decoded}; differing prompt codes, "
          f"emitted codes, prompt scales, emitted scales): {diffs}; "
          f"before the forced-token replay 14-23 codes differed (PERF.md, "
          f"PR 12 U1-U4, W1-W2: 34.0-55.3 tokens/s, remove_replica "
          f"656.5-2817.8 ms, continuation TTFT 7.0-34.9 s)", flush=True)
    return dict(launches=launches, launches_in_replays=L * steps)


def phase_card_vs_cpu(torch, lm, serving):
    cpu = lm.transformer_lm("base", vocab_size=50257, num_layers=2,
                            device="cpu", seed=5)
    gpu = lm.transformer_lm("base", vocab_size=50257, num_layers=2, seed=6)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, 50257, (n,), generator=g).tolist()
               for n in (40, 90)]
    with torch.inference_mode():
        toks = torch.tensor([prompts[1][:64]])
        lc = cpu(toks)
        lg = gpu(toks.cuda()).cpu()
    ferr = (lc - lg).abs().max().item()
    check(ferr <= 1e-3, f"forward logits card vs CPU differ by {ferr}")
    for quant, kernel in (("int8_kv", None), ("fp8_kv", None), (None, None),
                          ("int8_w", None), ("int8_kv", "xla")):
        outs = {}
        for name, net, dev in (("cuda", gpu, None), ("cpu", cpu, "cpu")):
            with serving.ServingEngine(net, slots=2, quant=quant,
                                       decode_kernel=kernel,
                                       device=dev) as eng:
                check(eng.stats()["decode_kernel"] == (
                    kernel or ("pallas" if quant and "kv" in quant
                               else "none")),
                      f"{quant}: decode_kernel {eng.stats()}")
                reqs = [eng.submit(p, 32) for p in prompts]
                outs[name] = [r.result(timeout=600) for r in reqs]
        for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            if a == b:
                continue
            j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
            with torch.inference_mode():
                ctx = torch.tensor([prompts[i] + b[:j]])
                top = torch.topk(cpu(ctx)[0, -1], 2).values
            raise SmokeFailure(
                f"{quant} ({kernel or 'auto'} read) request {i}: card and "
                f"CPU greedy tokens diverge "
                f"at new token {j} ({a[j]} vs {b[j]}); CPU fp32 forward "
                f"top-2 logit margin there {float(top[0] - top[1]):.3e}")
    print(f"card vs CPU, base width 2 layers: forward logits max diff "
          f"{ferr:.3e} (tol 1e-3); greedy tokens equal for 2 requests x 32, "
          f"int8_kv, fp8_kv, a float cache (quant=None), int8_w over a "
          f"float cache and int8_kv through the xla read "
          f"(decode_kernel='xla')", flush=True)


class SeqLoss:
    """``SoftmaxCrossEntropyLoss`` over (B*T, V), as the JAX package's
    benchmark wraps it."""

    def __init__(self, loss_mod):
        self.ce = loss_mod.SoftmaxCrossEntropyLoss()

    def __call__(self, logits, y):
        b, t, v = logits.shape
        return self.ce(logits.reshape(b * t, v), y.reshape(b * t))


TRAIN = dict(B=32, T=1024, micro_batches=4, vocab=16384, steps=24)


def _flagship(lm):
    return lm.transformer_lm("flagship", vocab_size=TRAIN["vocab"],
                             seed=10).cast("bfloat16")


def _train_batch(torch):
    import numpy as np
    rs = np.random.RandomState(0)
    B, T, V = TRAIN["B"], TRAIN["T"], TRAIN["vocab"]
    x = rs.randint(0, V, (B, T)).astype(np.int32)
    y = rs.randint(0, V, (B, T)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def attention_launches(attention):
    """The attention kernels' launch counts: K1 to K4 on both routes, and
    on their sm90 route."""
    return dict(K1=attention.flash_fwd.launches,
                K1_sm90=attention.flash_fwd.sm90_launches,
                K2=attention.flash_bwd_dq.launches,
                K2_sm90=attention.flash_bwd_dq.sm90_launches,
                K3=attention.flash_bwd_dkv.launches,
                K3_sm90=attention.flash_bwd_dkv.sm90_launches,
                K4=attention.flash_bwd_fused.launches,
                K4_sm90=attention.flash_bwd_fused.sm90_launches)


def phase_train(torch, lm, attention, optimizer, loss_mod, parallel,
                step_cache, counts):
    """The flagship in bf16 memorises one batch (the JAX package's training
    benchmark) through the captured step: the first step runs the body
    (the warm-up), the second captures the program, every later step
    replays it; returns the launch counts."""
    model = _flagship(lm)
    L, K = len(model.blocks), TRAIN["micro_batches"]
    B, T, steps = TRAIN["B"], TRAIN["T"], TRAIN["steps"]
    x, y = _train_batch(torch)
    dpt = parallel.DataParallelTrainer(model, SeqLoss(loss_mod),
                                       optimizer.Adam(learning_rate=3e-4),
                                       micro_batches=K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_cache.reset_stats("data_parallel_step")
    counts(0)
    t0 = time.monotonic()
    losses = [dpt.step_async(x, y)]
    loss_start = float(losses[0])
    first_s = time.monotonic() - t0
    t0 = time.monotonic()
    losses.append(dpt.step_async(x, y))     # captures, then replays
    float(losses[-1])
    second_s = time.monotonic() - t0
    t0 = time.monotonic()
    for _ in range(steps - 1):
        losses.append(dpt.step_async(x, y))
    loss_end = float(losses[-1])             # one readback syncs the chain
    dt = time.monotonic() - t0
    launches = attention_launches(attention)
    peak = torch.cuda.max_memory_allocated()
    stats = dpt.stats()
    cache = step_cache.snapshot()["data_parallel_step"]
    losses = [float(v) for v in losses]
    want = L * K * (steps + 1)
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(launches["K1"] == launches["K2"] == launches["K3"] == want
          and launches["K1_sm90"] == launches["K2_sm90"]
          == launches["K3_sm90"] == want and launches["K4"] == 0,
          f"launches {launches}: want K1 = K2 = K3 = K1_sm90 = K2_sm90 = "
          f"K3_sm90 = {want} (layers {L} x micro-batches {K} x steps "
          f"{steps + 1}, replays counted), K4 = 0")
    check(cache["traces"] == 1 and cache["hits"] == steps
          and stats["captured"] == 1 and stats["replays"] == steps,
          f"data_parallel_step {cache}, trainer {stats}: want 1 trace, "
          f"{steps} hits, 1 capture and {steps} replays")
    check(loss_end < loss_start - 0.3,
          f"learning gate: loss {loss_start:.4f} -> {loss_end:.4f} (must "
          f"fall by 0.3)")
    step_ms = dt / (steps - 1) * 1e3
    all_ms = (second_s + dt) / steps * 1e3
    tok_s = B * T / (step_ms / 1e3)
    V, U, H = TRAIN["vocab"], model._units, model.blocks[0].attn._heads
    p_dense = sum(p.numel() for n, p in model.named_parameters()
                  if "embed" not in n) + V * U      # + the tied head
    pairs = T * (T + 1) // 2
    attn_flops = 3 * 4 * B * H * pairs * (U // H) * L   # fwd + 2x bwd
    flops = 6 * p_dense * B * T + attn_flops
    print(f"train flagship bf16 d{U} L{L} H{H} B{B} T{T} x{K} Adam(3e-4), "
          f"captured: loss {loss_start:.4f} -> {loss_end:.4f} over 1 + "
          f"{steps} steps (gate: fall by 0.3; uniform floor "
          f"{math.log(V):.2f}); first step (the body, on a side stream) "
          f"{first_s:.2f} s; second step (capture {stats['capture_ms']:.1f} "
          f"ms, of it recording {stats['record_ms']:.1f} ms, then a replay) "
          f"{second_s * 1e3:.1f} ms; {steps - 1} replays {step_ms:.2f} "
          f"ms/step, {tok_s:.1f} tokens/s ({all_ms:.2f} ms/step over the "
          f"{steps} steps after the first, capture included); "
          f"max_memory_allocated {peak} bytes; optimizer_state_bytes "
          f"{dpt.optimizer_state_bytes()}; data_parallel_step {cache}; "
          f"launches {launches} (= {L} x {K} x {steps + 1}); model "
          f"flops/step {flops:.4e} (6*P*tokens, P={p_dense}, + attention "
          f"{attn_flops:.4e}) = {flops / (step_ms / 1e3) / 1e12:.1f} "
          f"TFLOP/s = {flops / (step_ms / 1e3) / PEAK_FLOPS['bfloat16']:.4f} "
          f"of the 989 TFLOP/s bf16 peak", flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}", flush=True)
    cost = dpt.cost_analysis()
    dense = 6 * p_dense * B * T
    print(f"  cost_analysis (counted on the first step): flops "
          f"{cost['flops']:.4e} = {cost['flops'] / flops:.4f} x the hand "
          f"count {flops:.4e}; of it K1-K3 report "
          f"{cost['kernel flops']:.4e} (K1 4, K2 6, K3 8 x B*H*pairs*D a "
          f"layer: {18 * B * H * pairs * (U // H) * L:.4e}; the hand count "
          f"takes 12: {attn_flops:.4e}) and FlopCounterMode the products "
          f"{cost['flops'] - cost['kernel flops']:.4e} (6*P*tokens "
          f"{dense:.4e}); bytes accessed {cost['bytes accessed']:.4e}",
          flush=True)
    check(abs(cost["flops"] / flops - 1) <= 0.05,
          f"cost_analysis flops {cost['flops']:.4e} is not within 5% of the "
          f"hand count {flops:.4e}")
    count_cost_ms(torch, dpt)
    profile_step(torch, dpt, x, y)
    return launches, step_ms


def count_cost_ms(torch, dpt):
    """What counting the cost adds to a key's first step: the step's body
    run eagerly alone and under ``flops.estimate_step_cost`` (as the first
    step runs it), in turn, twice each, each call synced."""
    from mxtpu_torch.observability import flops
    body = dpt._last.body
    ms = {"alone": [], "counted": []}
    for which in ("alone", "counted", "counted", "alone"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "alone":
            body()
        else:
            flops.estimate_step_cost(body)
        torch.cuda.synchronize()
        ms[which].append((time.perf_counter() - t0) * 1e3)
    alone, counted = min(ms["alone"]), min(ms["counted"])
    print(f"  cost count on the first step: the body eagerly {alone:.1f} ms "
          f"{[round(v, 1) for v in ms['alone']]}, under the counters "
          f"{counted:.1f} ms {[round(v, 1) for v in ms['counted']]}: "
          f"+{counted - alone:.1f} ms once a program key", flush=True)


def profile_step(torch, dpt, x, y, label="train"):
    """One training step (a replay) under ``torch.profiler`` (device
    activity): its device-busy share of the wall and its top device
    operations. ``dpt`` is anything with ``step(x, y)``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dpt.step(x, y)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name = {}
    for name, on_device, us in profile_events(torch, prof):
        if on_device:
            by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(by_name.values())
    if not busy:
        print(f"profile {label}: the profiler recorded no device time",
              flush=True)
        return
    print(f"profile {label} (1 step, profiler on): wall {wall_us / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of "
          f"wall, idle {1 - busy / wall_us:.3f}", flush=True)
    # the top 10, and every attention kernel wherever it ranks
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for rank, (name, us) in enumerate(ranked):
        if rank < 10 or "flash_" in name:
            print(f"  {us / busy:.3f} of device time, {us / 1e3:.1f} ms: "
                  f"{name[:110]}", flush=True)


def _trained(torch, dpt, model, batches, eager, hook_masks=False):
    """``dpt`` over ``batches`` by ``step_async`` (the first step runs the
    body, the second captures, the rest replay) or ``eager_step`` (the body
    every step); returns losses, weights, optimizer states and, with
    ``hook_masks``, each step's dropout masks (recorded by hooks, which
    run on every eager step)."""
    masks, step_masks = [], []
    if hook_masks:
        for d in model.modules():
            if type(d).__name__ == "Dropout":
                d.register_forward_hook(
                    lambda mod, inp, out: step_masks.append(out == 0))
    losses = []
    for x, y in batches:
        step_masks.clear()
        losses.append(dpt.eager_step(x, y) if eager else dpt.step_async(x, y))
        masks.append(list(step_masks))
    return ([float(v) for v in losses],
            [p.detach().clone() for p in model.parameters()],
            [s.clone() for st in dpt._states for s in st], masks)


def update_parity(torch, step_cache, optimizer, params, grads, label):
    """The multi-tensor update (``step_cache.build_update_all``, step values
    in a device tensor) against the per-tensor one
    (``build_update_all_plain``, Python floats) on the card: two updates
    with one step's gradients, under Adam and under SGD with momentum and
    clip, with mixed lr and wd multipliers; weights and states must be
    ``torch.equal``."""
    lr_mults = [(1.0, 0.5, 0.3)[i % 3] for i in range(len(params))]
    wd_mults = [(1.0, 2.0, 0.7)[i % 3] for i in range(len(params))]
    for name, make in (
            ("Adam", lambda: optimizer.Adam(learning_rate=3e-4, wd=1e-2,
                                            clip_gradient=1e-3)),
            ("SGD momentum", lambda: optimizer.SGD(
                learning_rate=0.05, momentum=0.9, wd=1e-2,
                clip_gradient=1e-4))):
        opt = make()
        w = [p.detach().clone() for p in params]
        st = [opt.create_state(i, p) for i, p in enumerate(w)]
        upd = step_cache.build_update_all(opt, w, st, lr_mults, wd_mults)
        plain = step_cache.build_update_all_plain(opt, lr_mults, wd_mults)
        ref_w = [p.detach().clone() for p in params]
        ref_st = [opt.create_state(i, p) for i, p in enumerate(ref_w)]
        for t, lr in ((1, 3e-4), (2, 1.5e-4)):
            ref_w, ref_st = plain(ref_w, grads, ref_st, lr, opt.wd, 1.0,
                                  opt.clip_gradient, t)
            for a, g in zip(upd.grads, grads):
                a.copy_(g)
            upd(torch.tensor(upd.values(lr, opt.wd, 1.0, opt.clip_gradient,
                                        t), dtype=torch.float64,
                             device=w[0].device))
        bad = [i for i, (a, b) in enumerate(zip(w, ref_w))
               if not torch.equal(a, b)]
        bad_st = [i for i, (a, b) in enumerate(zip(st, ref_st))
                  if not all(torch.equal(u, v) for u, v in zip(a, b))]
        check(not bad and not bad_st,
              f"multi-tensor update ({label}, {name}) vs per-tensor: weights "
              f"{bad[:5]} and states {bad_st[:5]} of {len(w)} differ (max "
              f"weight diff "
              f"{_max_diff(torch, w, ref_w) if bad else 0.0:.3e})")
        print(f"  multi-tensor update = per-tensor update bit for bit "
              f"({label}, {name}, {len(w)} tensors in {len(upd.groups)} "
              f"groups, 2 updates)", flush=True)


def phase_train_program(torch, lm, attention, optimizer, lr_scheduler,
                        loss_mod, parallel, step_cache):
    """The training program against its body: from the same weights, 1 + 3
    steps through ``step_async`` (body, capture and replay, replays) and 1
    + 3 through ``eager_step`` (the body each time); losses, weights and
    optimizer states must be ``torch.equal``. Legs: the bf16 flagship under
    Adam (sm90 route); base width, 2 layers, f32 with dropout 0.1 and
    ``remat=True`` (simt route: finite losses, masks that differ between
    steps); the bf16 flagship under SGD with momentum, a
    ``FactorScheduler`` that halves lr every step, and ``clip_gradient``.
    Then the multi-tensor update against the per-tensor one on one step's
    gradients, in bf16 and f32."""
    import numpy as np
    K = TRAIN["micro_batches"]
    rs = np.random.RandomState(5)
    f32_batches = [tuple(torch.from_numpy(a).cuda() for a in (
        rs.randint(0, 16384, (4, 256)).astype(np.int32),
        rs.randint(0, 16384, (4, 256)).astype(np.float32)))
        for _ in range(4)]
    legs = {
        "bf16 flagship, Adam (sm90)": (
            lambda: _flagship(lm),
            lambda m: parallel.DataParallelTrainer(
                m, SeqLoss(loss_mod), optimizer.Adam(learning_rate=3e-4),
                micro_batches=K),
            [_train_batch(torch)] * 4, False),
        "f32 base width 2 layers, dropout 0.1, remat (simt)": (
            lambda: lm.transformer_lm("base", vocab_size=16384, num_layers=2,
                                      dropout=0.1, seed=11),
            lambda m: parallel.DataParallelTrainer(
                m, SeqLoss(loss_mod), optimizer.Adam(learning_rate=1e-3),
                micro_batches=2, remat=True),
            f32_batches, True),
        "bf16 flagship, SGD momentum, FactorScheduler, clip (sm90)": (
            lambda: _flagship(lm),
            lambda m: parallel.DataParallelTrainer(
                m, SeqLoss(loss_mod), optimizer.SGD(
                    learning_rate=0.5, momentum=0.9, clip_gradient=1e-4,
                    lr_scheduler=lr_scheduler.FactorScheduler(
                        step=1, factor=0.5)), micro_batches=K),
            [_train_batch(torch)] * 4, False),
    }
    grads = {}
    for name, (make_model, make_trainer, batches, dropout) in legs.items():
        runs = {}
        for eager in (False, True):
            model = make_model()
            dpt = make_trainer(model)
            runs[eager] = _trained(torch, dpt, model, batches, eager,
                                   hook_masks=dropout and eager)
            if not eager:
                stats = dpt.stats()
                lrs = dpt.optimizer.learning_rate
                if name.startswith(("bf16 flagship, Adam", "f32")):
                    grads[name] = ([p.detach().clone()
                                    for p in dpt._params],
                                   [g.clone() for g in dpt._update.grads])
            del model, dpt
            torch.cuda.empty_cache()
        (rl, rw, rst, _), (el, ew, est, masks) = runs[False], runs[True]
        check(stats["captured"] == 1 and stats["replays"] == 3,
              f"{name}: trainer {stats}, want 1 capture and 3 replays")
        check(all(math.isfinite(v) for v in rl), f"{name}: losses {rl}")
        same_w = all(torch.equal(a, b) for a, b in zip(rw, ew))
        same_st = all(torch.equal(a, b) for a, b in zip(rst, est))
        check(rl == el and same_w and same_st,
              f"{name}: replayed losses {rl} vs body {el}; weights "
              f"{'equal' if same_w else 'differ'} (max diff "
              f"{_max_diff(torch, rw, ew):.3e}), optimizer states "
              f"{'equal' if same_st else 'differ'}: want all bit-equal")
        extra = ""
        if dropout:
            n = len(masks[0])
            check(n > 0 and all(len(m) == n for m in masks) and all(
                not torch.equal(a, b) for s, u in zip(masks, masks[1:])
                for a, b in zip(s, u)),
                f"{name}: dropout masks must differ between steps "
                f"({[len(m) for m in masks]} calls a step)")
            kept = float(torch.stack([(~m).float().mean()
                                      for s in masks for m in s]).mean())
            extra = (f"; {n} dropout calls a step (forward and remat's "
                     f"recompute), masks differ between steps, kept "
                     f"share {kept:.4f}")
        print(f"train program vs body, {name}: 1 + 3 steps (capture "
              f"{stats['capture_ms']:.1f} ms), losses {rl} equal the "
              f"body's, weights and optimizer states bit-equal; lr after "
              f"the steps {lrs:g}{extra}", flush=True)
    for name, (params, g) in grads.items():
        update_parity(torch, step_cache, optimizer, params, g, name)


def _max_diff(torch, a, b):
    """Largest absolute difference over two lists of tensors, in f32 on
    the CPU."""
    return max((x.detach().float().cpu() - y.detach().float().cpu()).abs()
               .max().item() for x, y in zip(a, b))


def _split_and_fused(torch, attention, make_model, make_trainer, batches,
                     counts):
    """The same steps from the same weights with the split pair, then under
    ``MXTPU_FLASH_BWD=fused``; returns ``(losses, weights)`` by mode, the
    model's layer count and the fused run's launch counts."""
    runs = {}
    for mode in ("split", "fused"):
        model = make_model()
        L = len(model.blocks)
        dpt = make_trainer(model)
        if mode == "fused":
            os.environ["MXTPU_FLASH_BWD"] = "fused"
            counts(0)
        try:
            losses = [float(v) for v in
                      [dpt.step_async(x, y) for x, y in batches]]
            launches = attention_launches(attention)
        finally:
            os.environ.pop("MXTPU_FLASH_BWD", None)
        runs[mode] = (losses, [p.detach().clone()
                               for p in model.parameters()])
        del model, dpt
        torch.cuda.empty_cache()
    return runs, L, launches


def phase_fused(torch, lm, attention, optimizer, loss_mod, parallel, counts):
    """3 steps of the training run with the split pair, then 3 from the same
    weights under ``MXTPU_FLASH_BWD=fused``: K4 replaces K2 + K3, on the
    sm90 route (the bf16 flagship), then on the simt route (phase 10's f32
    model, base width, 2 layers, B=4, T=256, 2 micro-batches). K4 runs its
    route's K2 and K3 tile bodies, so the losses and the trained weights
    equal the split run's bit for bit. Returns K4's launches on each
    route."""
    import numpy as np
    K = TRAIN["micro_batches"]
    rs = np.random.RandomState(9)
    f32_batches = [tuple(torch.from_numpy(a).cuda() for a in (
        rs.randint(0, 16384, (4, 256)).astype(np.int32),
        rs.randint(0, 16384, (4, 256)).astype(np.float32)))
        for _ in range(3)]
    legs = {
        "sm90": (lambda: _flagship(lm),
                 lambda m: parallel.DataParallelTrainer(
                     m, SeqLoss(loss_mod),
                     optimizer.Adam(learning_rate=3e-4), micro_batches=K),
                 [_train_batch(torch)] * 3, K),
        "simt": (lambda: lm.transformer_lm("base", vocab_size=16384,
                                           num_layers=2, seed=11),
                 lambda m: parallel.DataParallelTrainer(
                     m, SeqLoss(loss_mod),
                     optimizer.Adam(learning_rate=1e-3), micro_batches=2),
                 f32_batches, 2),
    }
    k4 = {}
    for route, (make_model, make_trainer, batches, mb) in legs.items():
        runs, L, launches = _split_and_fused(torch, attention, make_model,
                                             make_trainer, batches, counts)
        want = L * mb * len(batches)
        check(launches["K4"] == want and launches["K4_sm90"] == (
            want if route == "sm90" else 0) and launches["K2"] == 0 and
            launches["K3"] == 0, f"fused {route} launches {launches}, want "
            f"K4 = {want} on the {route} route and no K2/K3")
        (split_losses, split_w), (losses, w) = runs["split"], runs["fused"]
        same_w = all(torch.equal(a, b) for a, b in zip(w, split_w))
        check(losses == split_losses and same_w,
              f"fused ({route}) losses {losses} vs split {split_losses}; "
              f"weights after {len(batches)} steps "
              f"{'equal' if same_w else 'differ'} (max diff "
              f"{_max_diff(torch, w, split_w):.3e}): want both bit-equal")
        print(f"fused backward ({route}): {len(batches)} steps, losses "
              f"{losses} equal the split run's, weights bit-equal; "
              f"launches {launches}", flush=True)
        k4[route] = launches["K4"]
    return k4


def phase_train_card_vs_cpu(torch, lm, attention, optimizer, loss_mod,
                            parallel, counts):
    """The same weights and batches train on the card and on the CPU (f32,
    base width, 2 layers, B=4, T=256): the gradients of the first batch,
    the losses of 3 Adam steps and the weights after them agree. Returns
    the card's attention launch counts: f32 takes the simt routes."""
    import numpy as np
    cpu = lm.transformer_lm("base", vocab_size=16384, num_layers=2,
                            device="cpu", seed=11)
    gpu = lm.transformer_lm("base", vocab_size=16384, num_layers=2, seed=12)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(9)
    batches = [(rs.randint(0, 16384, (4, 256)).astype(np.int32),
                rs.randint(0, 16384, (4, 256)).astype(np.float32))
               for _ in range(3)]
    grads, losses, weights = {}, {}, {}
    counts(0)
    for name, net, dev in (("cuda", gpu, "cuda"), ("cpu", cpu, "cpu")):
        x, y = (torch.from_numpy(a).to(dev) for a in batches[0])
        grads[name] = torch.autograd.grad(
            SeqLoss(loss_mod)(net(x), y).float().mean(),
            list(net.parameters()))
        dpt = parallel.DataParallelTrainer(
            net, SeqLoss(loss_mod), optimizer.Adam(learning_rate=1e-3),
            micro_batches=2, device=None if dev == "cuda" else dev)
        losses[name] = [dpt.step(x, y) for x, y in batches]
        weights[name] = dict(net.named_parameters())
    launches = attention_launches(attention)
    check(launches["K1"] > 0 and launches["K2"] == launches["K3"] > 0 and
          launches["K1_sm90"] == launches["K2_sm90"]
          == launches["K3_sm90"] == 0,
          f"f32 training launches {launches}: want K1, K2 = K3 > 0 on the "
          f"simt route")
    # each gradient against its own largest entry, floored at 1e-3 of the
    # model's: the key bias's gradient is 0 (softmax ignores a shift shared
    # by a row's logits), so both sides hold rounding noise there
    floor = 1e-3 * max(b.abs().max().item() for b in grads["cpu"])
    gdiff, gname = max(((a.cpu() - b).abs().max().item() / max(
        b.abs().max().item(), floor), n) for n, a, b in zip(
        weights["cpu"], grads["cuda"], grads["cpu"]))
    ldiff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    # Adam's first step, lr * g / (|g| + 3.2e-7), magnifies the rounding of
    # gradient entries near 3.2e-7
    wdiffs = sorted(((_max_diff(torch, [w], [weights["cpu"][n]]), n)
                     for n, w in weights["cuda"].items()), reverse=True)
    wdiff = wdiffs[0][0]
    gtol, ltol, wtol = 5e-5, 1e-5, 5e-5
    check(gdiff <= gtol and ldiff <= ltol and wdiff <= wtol,
          f"training card vs CPU: first-batch gradients differ by {gdiff} of "
          f"their largest entry (tol {gtol}), losses card {losses['cuda']} "
          f"vs CPU {losses['cpu']} by {ldiff} (tol {ltol}), weights after 3 "
          f"steps by {wdiffs[:3]} (tol {wtol})")
    print(f"train card vs CPU, base width 2 layers f32 B4 T256 x2: "
          f"first-batch gradients max diff {gdiff:.3e} of each tensor's "
          f"largest entry, in {gname} (tol {gtol:g}); 3 Adam steps, losses "
          f"card {losses['cuda']} CPU {losses['cpu']}, max diff "
          f"{ldiff:.3e} (tol {ltol:g}); weights max diff (tol {wtol:g}) "
          + ", ".join(f"{d:.3e} in {n}" for d, n in wdiffs[:3])
          + f"; launches {launches}", flush=True)
    return launches


GLUON = dict(B=8, T=1024, vocab=16384, steps=12)


def gluon_steps(mx, net, trainer, batches, ctx, sync=None):
    """Gluon steps (record, forward, loss, backward, ``trainer.step``);
    returns each step's mean loss as a float. ``sync`` (when given) is
    called after each step, for timing."""
    from mxtpu_torch import autograd, gluon, nd
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        xs, ys = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
        with autograd.record():
            loss = L(net(xs), ys)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.mean())
        if sync is not None:
            sync()
    return [float(v.asscalar()) for v in losses]


def gluon_weights(torch, net):
    return [p.data().data.detach().float().cpu()
            for p in net.collect_params().values()]


def weight_diffs(torch, net_a, net_b):
    """Each parameter's largest difference over its largest entry (in
    ``net_b``) or 1, whichever is larger: phase 10's absolute tolerance for
    the tensors whose entries stay within 1 (a bias whose true gradient is
    0, such as the key projection's, holds rounding noise that Adam
    normalises, so its own largest entry is no scale), relative above.
    Largest first, with the name."""
    out = []
    for (n, pa), pb in zip(net_a.collect_params().items(),
                           net_b.collect_params().values()):
        a = pa.data().data.detach().float().cpu()
        b = pb.data().data.detach().float().cpu()
        out.append(((a - b).abs().max().item()
                    / max(b.abs().max().item(), 1.0), n))
    return sorted(out, reverse=True)


def phase_gluon(torch, mx, lm, attention, parallel, loss_mod, step_cache,
                counts, smi, phase8_ms):
    """Phase 13: the Gluon front end on the card (see the module
    docstring). Returns leg (a)'s attention launch counts."""
    import tempfile
    import numpy as np
    from mxtpu_torch import gluon
    gpu = mx.gpu(0)
    B, T, V, steps = GLUON["B"], GLUON["T"], GLUON["vocab"], GLUON["steps"]
    # (a) the flagship through Gluon, bf16
    net = lm.transformer_lm("flagship", vocab_size=V)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net.cast("bfloat16")
    L = len(net.blocks)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-4})
    rs = np.random.RandomState(0)
    batch = (rs.randint(0, V, (B, T)).astype(np.int32),
             rs.randint(0, V, (B, T)).astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_cache.reset_stats("trainer_update")
    times = []

    def tick():
        torch.cuda.synchronize()
        times.append(time.perf_counter())

    counts(0)
    tick()
    losses = gluon_steps(mx, net, trainer, [batch] * steps, gpu, sync=tick)
    launches = attention_launches(attention)
    peak = torch.cuda.max_memory_allocated()
    cache = step_cache.snapshot()["trainer_update"]
    (entry,) = trainer._bulk_cache.values()
    prog = entry.program
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    want = L * steps
    check(all(math.isfinite(v) for v in losses), f"gluon losses {losses}")
    check(all(launches[k] == want for k in ("K1", "K2", "K3", "K1_sm90",
                                            "K2_sm90", "K3_sm90"))
          and launches["K4"] == 0,
          f"gluon launches {launches}: want K1 = K2 = K3 = their sm90 "
          f"counts = {want} ({L} layers x {steps} steps), K4 = 0")
    check(cache == {"hits": steps - 1, "traces": 1, "retraces": 0}
          and prog is not None and prog.graph is not None
          and prog.replays == steps,
          f"gluon update program: trainer_update {cache}, replays "
          f"{getattr(prog, 'replays', None)}: want it captured on step 1 "
          f"and replayed on all {steps} steps")
    check(losses[-1] < losses[0] - 0.3,
          f"gluon learning gate: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(must fall by 0.3)")
    med = float(np.median(step_ms[2:]))
    print(f"gluon (a): flagship bf16 d{net._units} L{L} through "
          f"initialize(Xavier) + Trainer(adam 3e-4), B{B} T{T}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps; step 1 "
          f"{step_ms[0]:.1f} ms (the update captured in "
          f"{prog.capture_ms:.1f} ms), median of the last 10 {med:.2f} "
          f"ms/step = {B * T / med * 1e3:.1f} tokens/s (phase 8's captured "
          f"step for the same {B}x{T} tokens: {phase8_ms / 4:.2f} ms, for "
          f"information); max_memory_allocated {peak} bytes; "
          f"trainer_update {cache}, program replays {prog.replays}; "
          f"launches {launches}; {smi}", flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}; ms/step "
          f"{[round(v, 2) for v in step_ms]}", flush=True)
    del net, trainer, entry, prog
    torch.cuda.empty_cache()

    # (b) card vs CPU, f32, full width, 2 layers, one .params file
    rs = np.random.RandomState(13)
    small = [(rs.randint(0, V, (2, 256)).astype(np.int32),
              rs.randint(0, V, (2, 256)).astype(np.float32))
             for _ in range(6)]
    with tempfile.TemporaryDirectory() as tmp:
        f = os.path.join(tmp, "w.params")
        card = lm.transformer_lm("flagship", vocab_size=V, num_layers=2)
        card.initialize(mx.init.Xavier(), ctx=gpu)
        card.save_parameters(f)
        host = lm.transformer_lm("flagship", vocab_size=V, num_layers=2,
                                 device="cpu")
        host.load_parameters(f)
        res = {}
        for name, net, ctx in (("card", card, gpu), ("cpu", host, mx.cpu())):
            with mx.Context(ctx):
                tr = gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})
                first = gluon_steps(mx, net, tr, small[:3], ctx)
                tr = gluon.Trainer(net.collect_params(), "rmsprop",
                                   {"learning_rate": 1e-4,
                                    "centered": True})
                res[name] = first + gluon_steps(mx, net, tr, small[3:], ctx)
        ldiff = max(abs(a - b) for a, b in zip(res["card"], res["cpu"]))
        wdiffs = weight_diffs(torch, card, host)
        check(ldiff <= 1e-5 and wdiffs[0][0] <= 5e-5,
              f"gluon card vs CPU: losses card {res['card']} CPU "
              f"{res['cpu']} differ by {ldiff} (tol 1e-5); weights by "
              f"{wdiffs[:3]} of each tensor's largest entry or 1 (tol "
              f"5e-5)")
        print(f"gluon (b): card vs CPU, flagship width 2 layers f32 B2 "
              f"T256, one .params file, 3 Adam + 3 RMSProp(centered) "
              f"steps: losses card {res['card']} CPU {res['cpu']}, max "
              f"diff {ldiff:.3e} (tol 1e-5); weights max diff of each "
              f"tensor's largest entry or 1 "
              + ", ".join(f"{d:.3e} in {n}" for d, n in wdiffs[:3])
              + " (tol 5e-5)", flush=True)

        # (e) DataParallelTrainer takes the Gluon-built net: its first loss
        # is the Gluon path's first loss on the same weights
        fresh = lm.transformer_lm("flagship", vocab_size=V, num_layers=2)
        fresh.load_parameters(f)
        x, y = (torch.from_numpy(a).cuda() for a in small[0])
        dpt = parallel.DataParallelTrainer(
            fresh, SeqLoss(loss_mod), mx.optimizer.Adam(learning_rate=1e-3),
            micro_batches=1)
        dpt_loss = float(dpt.step(x, y))
        check(abs(dpt_loss - res["card"][0]) <= 1e-5,
              f"gluon (e): DataParallelTrainer's first loss {dpt_loss} vs "
              f"the Gluon path's {res['card'][0]} (tol 1e-5)")
        print(f"gluon (e): DataParallelTrainer(micro_batches=1) on the "
              f"Gluon-built net: first loss {dpt_loss} vs Gluon "
              f"{res['card'][0]}, diff {abs(dpt_loss - res['card'][0]):.3e} "
              f"(tol 1e-5)", flush=True)
        del fresh, dpt, host

        # (c) multi_precision: bf16 weights, f32 masters
        card.cast("bfloat16")
        tr = gluon.Trainer(card.collect_params(), "adam",
                           {"learning_rate": 1e-3, "multi_precision": True})
        gluon_steps(mx, card, tr, small[:3], gpu)
        params = list(card.collect_params().values())
        bad = [p.name for p, st in zip(params, tr._states)
               if not torch.equal(p.data().data,
                                  st[0].to(torch.bfloat16))]
        check(not bad and all(st[0].dtype == torch.float32
                              for st in tr._states),
              f"gluon (c): bf16 weights that are not their f32 master "
              f"cast: {bad}")
        print(f"gluon (c): multi_precision Adam, 3 steps: all "
              f"{len(params)} bf16 weights equal their f32 masters cast to "
              f"bf16", flush=True)

        # (d) save and resume: the next step equals the uninterrupted one
        fs, fp = os.path.join(tmp, "r.states"), os.path.join(tmp, "r.params")
        card.cast("float32")
        tr = gluon.Trainer(card.collect_params(), "adam",
                           {"learning_rate": 1e-3})
        gluon_steps(mx, card, tr, small[:2], gpu)
        card.save_parameters(fp)
        tr.save_states(fs)
        again = lm.transformer_lm("flagship", vocab_size=V, num_layers=2)
        again.load_parameters(fp)
        same = all(torch.equal(a, b) for a, b in zip(
            gluon_weights(torch, card), gluon_weights(torch, again)))
        tr2 = gluon.Trainer(again.collect_params(), "adam",
                            {"learning_rate": 1e-3})
        tr2.load_states(fs)
        la = gluon_steps(mx, card, tr, small[2:3], gpu)
        lb = gluon_steps(mx, again, tr2, small[2:3], gpu)
        nxt = all(torch.equal(a, b) for a, b in zip(
            gluon_weights(torch, card), gluon_weights(torch, again)))
        check(same and nxt and la == lb,
              f"gluon (d): loaded parameters bit-equal {same}; the resumed "
              f"step's loss {lb} vs {la} and weights bit-equal {nxt}")
        print(f"gluon (d): save_parameters -> load_parameters bit-equal; "
              f"save_states -> a fresh Trainer's load_states: the next "
              f"step's loss {lb[0]} and weights equal the uninterrupted "
              f"run's bit for bit", flush=True)
    return launches, med


# ---------------------------------------------------------------------------
# phase 14: the symbolic and Module front ends
# ---------------------------------------------------------------------------

MODULE = dict(B=8, T=1024, vocab=16384, epochs=12, chain=4, chain_B=2,
              chain_batches=9, sym_steps=10)


def module_loss(mx, torch, mod):
    """``Module.fit``'s metric here: the step's mean loss (per-sample losses
    of a Block module; the cross-entropy of a symbolic module's
    probabilities), read back each step, so a step's time is the device's;
    the probabilities themselves are not copied to the host."""

    class ModuleLoss(mx.metric.EvalMetric):
        def __init__(self):
            self.losses = []
            super().__init__("loss")

        def update(self, labels, preds):
            if mod._loss_val is not None:
                v = mod._loss_val.data.detach().float().mean()
            else:
                p = preds[0].data.detach().float()
                y = labels[0].data.to(p.device).long().unsqueeze(-1)
                v = -torch.log(p.gather(-1, y).clamp_min(1e-30)).mean()
            self.losses.append(float(v))
            self.sum_metric += self.losses[-1]
            self.num_inst += 1

    return ModuleLoss()


def module_fit(torch, mx, mod, it, epochs, optimizer, params, **kw):
    """``mod.fit`` with :func:`module_loss`; returns the losses and each
    step's ms (host clock, the loss read back closing each step)."""
    metric = module_loss(mx, torch, mod)
    times = []

    def tick(_=None):
        torch.cuda.synchronize()
        times.append(time.perf_counter())

    tick()
    mod.fit(it, num_epoch=epochs, optimizer=optimizer,
            optimizer_params=dict(params), eval_metric=metric,
            batch_end_callback=tick, **kw)
    return metric.losses, [(b - a) * 1e3 for a, b in zip(times, times[1:])]


def lm_symbol(s, units, heads, vocab, T):
    """Embedding -> FullyConnected(3 units) -> q, k, v (B, H, T, D) ->
    ``contrib.flash_attention(causal)`` -> FullyConnected(vocab) ->
    SoftmaxOutput, built with ``mx.sym``."""
    D = units // heads
    data = s.Variable("data")
    e = s.Embedding(data, input_dim=vocab, output_dim=units, name="embed")
    qkv = s.FullyConnected(e, num_hidden=3 * units, flatten=False,
                           name="qkv")
    qkv = s.transpose(s.reshape(qkv, shape=(-1, T, 3, heads, D)),
                      axes=(2, 0, 3, 1, 4))
    q, k, v = s.split(qkv, num_outputs=3, axis=0, squeeze_axis=True)
    att = s.contrib.flash_attention(q, k, v, causal=True)
    o = s.reshape(s.transpose(att, axes=(0, 2, 1, 3)), shape=(-1, T, units))
    logits = s.FullyConnected(o, num_hidden=vocab, flatten=False, name="out")
    return s.SoftmaxOutput(logits, name="softmax")


def bind_lm_symbol(torch, mx, net, ctx, B, T, vocab, seed):
    """``simple_bind`` of :func:`lm_symbol` on ``ctx`` with seeded weights
    (N(0, 0.02), drawn on the CPU) and a seeded batch."""
    import numpy as np
    ex = net.simple_bind(ctx, data=(B, T))
    g = torch.Generator().manual_seed(seed)
    for n, a in ex.arg_dict.items():
        if n not in ("data", "softmax_label"):
            a._set_data((torch.randn(a.shape, generator=g) * 0.02)
                        .to(a.data.device))
    rs = np.random.RandomState(seed)
    batch = dict(data=mx.nd.array(rs.randint(0, vocab, (B, T))
                                  .astype(np.int32), ctx=ctx),
                 softmax_label=mx.nd.array(rs.randint(0, vocab, (B, T))
                                           .astype(np.float32), ctx=ctx))
    return ex, batch


def ms_or(ms, per=1):
    """``ms / per`` as text, or "not run" when that phase did not run."""
    return "not run" if ms is None else f"{ms / per:.2f} ms"


def phase_module(torch, mx, lm, attention, step_cache, counts, smi,
                 phase8_ms, phase13_ms):
    """Phase 14: the Module and symbolic front ends on the card (see the
    module docstring). Returns (a)'s and (c)'s attention launch counts."""
    import tempfile
    import numpy as np
    from mxtpu_torch import engine, io, sym
    from mxtpu_torch.gluon import SymbolBlock
    gpu = mx.gpu(0)
    B, T, V = MODULE["B"], MODULE["T"], MODULE["vocab"]
    epochs = MODULE["epochs"]
    tmp = tempfile.mkdtemp(prefix="phase14_")
    rs = np.random.RandomState(0)
    x = rs.randint(0, V, (B, T)).astype(np.int32)
    y = rs.randint(0, V, (B, T)).astype(np.float32)

    # (a) Module.fit on the flagship, bf16, through the fused step
    net = lm.transformer_lm("flagship", vocab_size=V)
    L = len(net.blocks)
    mod = mx.mod.Module(net)
    it = io.NDArrayIter(x, y, batch_size=B)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    net.cast("bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_cache.reset_stats("module_step")
    counts(0)
    losses, step_ms = module_fit(torch, mx, mod, it, epochs, "adam",
                                 {"learning_rate": 3e-4})
    launches = attention_launches(attention)
    peak = torch.cuda.max_memory_allocated()
    cache = step_cache.snapshot()["module_step"]
    st = mod._step_exec.stats()
    want = L * epochs
    check(all(math.isfinite(v) for v in losses), f"module losses {losses}")
    check(all(launches[k] == want for k in ("K1", "K2", "K3", "K1_sm90",
                                            "K2_sm90", "K3_sm90"))
          and launches["K4"] == 0,
          f"module (a) launches {launches}: want K1 = K2 = K3 = their sm90 "
          f"counts = {want} ({L} layers x {epochs} steps), K4 = 0")
    check(cache == {"hits": epochs - 1, "traces": 1, "retraces": 0}
          and st["programs"] == 1 and st["captured"] == 1
          and st["replays"] == epochs - 1,
          f"module (a) step program: module_step {cache}, {st}: want one "
          f"program, captured once, {epochs - 1} replays")
    check(losses[-1] < losses[0] - 0.3,
          f"module learning gate: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(must fall by 0.3)")
    med = float(np.median(step_ms[2:]))
    flops = mod._program_flops()
    print(f"module (a): Module(flagship bf16 d{net._units} L{L}).fit("
          f"NDArrayIter B{B} T{T}, adam 3e-4, {epochs} epochs): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step 1 (body on a side "
          f"stream) {step_ms[0]:.1f} ms, step 2 (capture + replay) "
          f"{step_ms[1]:.1f} ms (capture {st['capture_ms']:.1f} ms), median "
          f"of the last 10 {med:.2f} ms/step = {B * T / med * 1e3:.1f} "
          f"tokens/s; phase 13's eager Gluon step {ms_or(phase13_ms)} and "
          f"phase 8's captured step {ms_or(phase8_ms, 4)} for the same "
          f"{B}x{T} tokens; program FLOPs {flops:.4e}; max_memory_allocated "
          f"{peak} bytes; module_step {cache}; launches {launches}; {smi}",
          flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}; ms/step "
          f"{[round(v, 2) for v in step_ms]}", flush=True)
    batch = next(iter(io.NDArrayIter(x, y, batch_size=B)))

    class FitStep:
        """One step of the fit loop (a replay), its loss read back."""

        def step(self, *_):
            mod.forward_backward(batch)
            mod.update()
            float(mod._loss_val.data.float().mean())

    profile_step(torch, FitStep(), None, None, label="module step")

    # (d) predict(chain=4) against predict(chain=1), bit for bit
    cb, nb, chain = MODULE["chain_B"], MODULE["chain_batches"], \
        MODULE["chain"]
    xp = np.random.RandomState(1).randint(0, V, (cb * nb, T)).astype(
        np.int32)
    pit = io.NDArrayIter(xp, None, batch_size=cb)
    per = mod.predict(pit)
    step_cache.reset_stats("serving_chained")
    counts(0)
    chained = mod.predict(pit, chain=chain)
    torch.cuda.synchronize()
    k1 = attention.flash_fwd.launches
    cstats = step_cache.snapshot()["serving_chained"]
    n_tail = nb % chain
    want_k1 = L * nb + L * (chain + n_tail)
    same = torch.equal(per.data, chained.data)
    check(same and k1 == want_k1 and cstats["traces"] == 2,
          f"module (d): chained equals per-batch {same}; K1 launches {k1} "
          f"(want {L} x {nb} + the warm-ups {L} x ({chain} + {n_tail}) = "
          f"{want_k1}); serving_chained {cstats} (want 2 traces)")
    print(f"module (d): predict(chain={chain}) over {nb} batches of B{cb} "
          f"T{T} ({nb // chain} chains of {chain} and a tail of {n_tail}): "
          f"bit-equal to predict(chain=1); serving_chained {cstats}; K1 "
          f"launches {k1} = {L} x {nb} + the captures' warm-ups", flush=True)
    del per, chained

    # (f) save_checkpoint -> load_checkpoint into a new Module: bit-equal
    prefix = os.path.join(tmp, "flagship")
    mod.save_checkpoint(prefix, epochs)
    _, arg, aux = mx.model.load_checkpoint(prefix, epochs)
    net2 = lm.transformer_lm("flagship", vocab_size=V).cast("bfloat16")
    mod2 = mx.mod.Module(net2)
    fit2 = io.NDArrayIter(xp[:2 * cb], None, batch_size=cb)
    mod2.bind(fit2.provide_data, None, for_training=False)
    mod2.init_params(arg_params=arg, aux_params=aux)
    same = torch.equal(mod.predict(fit2).data, mod2.predict(fit2).data)
    check(same, "module (f): a Module loaded from save_checkpoint predicts "
          "other bits than the saved one")
    print(f"module (f): save_checkpoint({epochs}) -> load_checkpoint -> a "
          f"new Module: bit-equal predictions", flush=True)
    del mod, mod2, net, net2, arg, aux
    torch.cuda.empty_cache()

    # (b) card against CPU: full width, 2 layers, f32, B2 T256, 3 steps
    rs = np.random.RandomState(14)
    xb = rs.randint(0, V, (6, 256)).astype(np.int32)
    yb = rs.randint(0, V, (6, 256)).astype(np.float32)
    f = os.path.join(tmp, "b.params")
    card = lm.transformer_lm("flagship", vocab_size=V, num_layers=2)
    card.initialize(mx.init.Xavier(), ctx=gpu)
    card.save_parameters(f)
    host = lm.transformer_lm("flagship", vocab_size=V, num_layers=2,
                             device="cpu")
    host.load_parameters(f)
    eager = lm.transformer_lm("flagship", vocab_size=V, num_layers=2)
    eager.load_parameters(f)
    res = {}
    for name, net, ctx, bulk in (("card", card, gpu, None),
                                 ("cpu", host, mx.cpu(), None),
                                 ("eager", eager, gpu, 0)):
        m = mx.mod.Module(net, context=ctx)
        it = io.NDArrayIter(xb, yb, batch_size=2)
        if bulk is None:
            res[name] = module_fit(torch, mx, m, it, 1, "adam",
                                   {"learning_rate": 1e-3})[0]
        else:
            with engine.bulk(bulk):
                res[name] = module_fit(torch, mx, m, it, 1, "adam",
                                       {"learning_rate": 1e-3})[0]
        if name == "card":
            check(m._step_exec.stats()["replays"] == 2,
                  f"module (b): card steps {m._step_exec.stats()}")
        if name == "eager":
            check(m._step_exec is None, "module (b): bulk(0) fused a step")
    for other in ("cpu", "eager"):
        ref = host if other == "cpu" else eager
        ldiff = max(abs(a - b) for a, b in zip(res["card"], res[other]))
        wdiffs = weight_diffs(torch, card, ref)
        check(ldiff <= 1e-5 and wdiffs[0][0] <= 5e-5,
              f"module (b): fused card vs {other}: losses {res['card']} vs "
              f"{res[other]} differ by {ldiff} (tol 1e-5); weights by "
              f"{wdiffs[:3]} of each tensor's largest entry or 1 (tol 5e-5)")
        bits = res["card"] == res[other] and all(
            torch.equal(a.data().data.cpu(), b.data().data.cpu())
            for a, b in zip(card.collect_params().values(),
                            ref.collect_params().values()))
        print(f"module (b): fused on the card vs {other} (flagship width, 2 "
              f"layers, f32, B2 T256, 3 Adam steps): losses "
              f"{res['card']} vs {res[other]}, max diff {ldiff:.3e} (tol "
              f"1e-5); weights max diff of each tensor's largest entry or 1 "
              + ", ".join(f"{d:.3e} in {n}" for d, n in wdiffs[:3])
              + f" (tol 5e-5); bit-equal: {bits}", flush=True)
    del card, host, eager
    torch.cuda.empty_cache()

    # (c) a graph built with mx.sym at full width, f32: K1-K3 once each
    net = lm_symbol(sym, 1024, 16, V, T)
    ex, batch = bind_lm_symbol(torch, mx, net, gpu, B, T, V, seed=3)
    counts(0)
    ex.forward(is_train=True, **batch)
    ex.backward()
    torch.cuda.synchronize()
    sym_launches = attention_launches(attention)
    check(sym_launches["K1"] == sym_launches["K2"] == sym_launches["K3"] == 1
          and sym_launches["K1_sm90"] == sym_launches["K2_sm90"] == 0,
          f"module (c): one forward and backward of the graph launched "
          f"{sym_launches}: want K1 = K2 = K3 = 1, on the simt route (f32)")
    # tojson -> load_json -> a new bind: bit-equal outputs
    out1 = ex.forward(is_train=False)[0].data.clone()
    ex2 = sym.load_json(net.tojson()).bind(
        gpu, dict(ex.arg_dict), aux_states=dict(ex.aux_dict),
        grad_req="null")
    same = torch.equal(ex2.forward(is_train=False)[0].data, out1)
    check(same, "module (c): tojson -> load_json -> bind gives other bits")
    del ex, ex2, out1
    # B1 T256: the card's outputs and gradients against the CPU's
    small = lm_symbol(sym, 1024, 16, V, 256)
    outs, grads = {}, {}
    for name, ctx in (("card", gpu), ("cpu", mx.cpu())):
        e, b = bind_lm_symbol(torch, mx, small, ctx, 1, 256, V, seed=4)
        outs[name] = e.forward(is_train=True, **b)[0].data.float().cpu()
        e.backward()
        grads[name] = {n: g.data.float().cpu()
                       for n, g in e.grad_dict.items()
                       if n not in ("data", "softmax_label")}
    odiff = (outs["card"] - outs["cpu"]).abs().max().item()
    floor = 1e-3 * max(g.abs().max().item() for g in grads["cpu"].values())
    gdiff, gname = max(((grads["card"][n] - g).abs().max().item()
                        / max(g.abs().max().item(), floor), n)
                       for n, g in grads["cpu"].items())
    check(odiff <= 1e-5 and gdiff <= 5e-5,
          f"module (c): card vs CPU at B1 T256: outputs differ by {odiff} "
          f"(tol 1e-5), gradients by {gdiff} in {gname} of the tensor's "
          f"largest entry (tol 5e-5)")
    # Module over the symbol: 10 eager steps memorise one batch
    smod = mx.mod.Module(net)
    sit = io.NDArrayIter(x, y, batch_size=B)
    # lr 1e-2: the one-layer graph has no norm or residual, and at 1e-3
    # its loss fell 0.25 in 10 steps (PR 14's second card run)
    slosses, sms = module_fit(torch, mx, smod, sit, MODULE["sym_steps"],
                              "adam", {"learning_rate": 1e-2},
                              initializer=mx.init.Xavier())
    check(smod._step_exec is None and slosses[-1] < slosses[0] - 0.3,
          f"module (c): the symbolic Module's loss {slosses[0]:.4f} -> "
          f"{slosses[-1]:.4f} (must fall by 0.3, eagerly)")
    print(f"module (c): lm_symbol (embed, qkv, contrib.flash_attention "
          f"causal, out, SoftmaxOutput; d1024 H16 V{V}) simple_bind on the "
          f"card, f32 (K1-K3 take the simt route): forward + backward at "
          f"B{B} T{T} launched {sym_launches}; tojson -> load_json -> bind "
          f"bit-equal; card vs CPU at B1 T256: outputs max diff "
          f"{odiff:.3e} (tol 1e-5), gradients {gdiff:.3e} of each tensor's "
          f"largest entry in {gname} (tol 5e-5); Module(symbol).fit "
          f"{MODULE['sym_steps']} eager Adam(1e-2) steps: loss "
          f"{slosses[0]:.4f} "
          f"-> {slosses[-1]:.4f}, median {float(np.median(sms[2:])):.2f} "
          f"ms/step", flush=True)
    # (f) the symbol's checkpoint through SymbolBlock.imports: bit-equal
    sprefix = os.path.join(tmp, "lm_symbol")
    smod.save_checkpoint(sprefix, MODULE["sym_steps"])
    blk = SymbolBlock.imports(f"{sprefix}-symbol.json", ["data"],
                              f"{sprefix}-{MODULE['sym_steps']:04d}.params")
    xs = mx.nd.array(x, ctx=gpu)
    with mx.autograd.predict_mode():
        got = blk(xs).data
    want_out = smod.predict(io.NDArrayIter(x, None, batch_size=B)).data
    check(torch.equal(got, want_out),
          "module (f): SymbolBlock.imports of the symbolic Module's "
          "checkpoint gives other bits")
    print("module (f): the symbolic Module's save_checkpoint -> "
          "SymbolBlock.imports(prefix-symbol.json, ['data'], "
          "prefix-####.params): bit-equal outputs", flush=True)
    del smod, blk, got, want_out
    torch.cuda.empty_cache()

    # (e) BucketingModule: T 512 and 1024 over one flagship weight set
    net = lm.transformer_lm("flagship", vocab_size=V)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net.cast("bfloat16")
    bm = mx.mod.BucketingModule(
        lambda key: (net, ("data",), ("softmax_label",)),
        default_bucket_key=T)
    bm.bind([io.DataDesc("data", (B, T))],
            [io.DataDesc("softmax_label", (B, T))])
    bm.init_params()
    bm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 3e-4})
    step_cache.reset_stats("module_step")
    rs = np.random.RandomState(5)
    blosses = []
    for key in (512, T) * 3:
        b = io.DataBatch(
            [mx.nd.array(rs.randint(0, V, (B, key)).astype(np.int32),
                         ctx=gpu)],
            [mx.nd.array(rs.randint(0, V, (B, key)).astype(np.float32),
                         ctx=gpu)],
            bucket_key=key,
            provide_data=[io.DataDesc("data", (B, key))],
            provide_label=[io.DataDesc("softmax_label", (B, key))])
        bm.forward_backward(b)
        bm.update()
        blosses.append(float(
            bm._curr._loss_val.data.detach().float().mean()))
    mods = [bm._modules[512], bm._modules[T]]
    stats = [m._step_exec.stats() for m in mods]
    progs = [next(iter(m._step_exec._cache.values())) for m in mods]
    shared = mods[0]._trainer is mods[1]._trainer and all(
        a is b for a, b in zip(progs[0].upd.states, progs[1].upd.states))
    n_params = len(net.collect_params())
    cache = step_cache.snapshot()["module_step"]
    check(all(s["programs"] == 1 and s["captured"] == 1 and s["replays"] == 2
              for s in stats) and shared
          and len(mods[0]._trainer._states) == n_params
          and cache["traces"] == 2 and all(map(math.isfinite, blosses)),
          f"module (e): per-bucket programs {stats}, one trainer and one "
          f"state a weight {shared}, module_step {cache}, losses {blosses}")
    print(f"module (e): BucketingModule over one flagship bf16 weight set, "
          f"buckets T512 and T{T} interleaved, 3 steps each: one program a "
          f"bucket, each captured once and replayed twice {stats}; one "
          f"Trainer and one optimizer state tuple for each of the "
          f"{n_params} weights, shared by both programs; module_step "
          f"{cache}; losses {[round(v, 4) for v in blosses]}", flush=True)
    del bm, mods, progs, net
    torch.cuda.empty_cache()
    return launches, sym_launches


# ---------------------------------------------------------------------------
# K6: CUDA C compiled at runtime through mxtpu_torch.rtc. The sources below
# are the user's code, as tests/test_rtc.py's SAXPY_SRC is for the JAX
# package; their plain versions are the numpy and nd expressions beside them.
# ---------------------------------------------------------------------------

SAXPY_SRC = r"""
extern "C" __global__ void saxpy(const float *x, const float *y, float *out,
                                 float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a * x[i] + y[i];
}

// one block per tile of 8 rows x cols; its threads stride over the tile
extern "C" __global__ void tile_double(const float *x, float *out, int cols) {
  const long base = (long)blockIdx.x * 8 * cols;
  for (int k = threadIdx.x; k < 8 * cols; k += blockDim.x)
    out[base + k] = x[base + k] + x[base + k];
}

// each block reverses its segment of seg floats through dynamic shared
// memory (seg * 4 bytes: above the 48 KB static limit at seg = 16384)
extern "C" __global__ void segment_reverse(const float *x, float *out,
                                           int seg) {
  extern __shared__ float buf[];
  const long base = (long)blockIdx.x * seg;
  for (int k = threadIdx.x; k < seg; k += blockDim.x) buf[k] = x[base + k];
  __syncthreads();
  for (int k = threadIdx.x; k < seg; k += blockDim.x)
    out[base + k] = buf[seg - 1 - k];
}
"""
SAXPY_SIG = "const float *x, const float *y, float *out, float a, int n"
TILE_SIG = "const float *x, float *out, int cols"
REVERSE_SIG = "const float *x, float *out, int seg"

AXPY_SRC = r"""
template <typename T>
__global__ void axpy(const T *x, T *y, T alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += alpha * x[i];
}
"""

# Per-row softmax cross-entropy over V logits: one block per row; the row
# max and the sum of exponentials are reduced through warp shuffles and one
# float per warp of dynamic shared memory. The backward recomputes the
# row's log-sum-exp (its second read of the 64 KB row mostly hits L2) and
# writes (softmax - onehot) * the row's out_grad.
CE_SRC = r"""
__device__ float block_reduce(float v, float *red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float id = is_max ? __int_as_float(0xff800000) : 0.f;
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : id;
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red is reused by the next reduction
  return v;
}

__device__ float row_lse(const float *x, int V, float *red) {
  float m = __int_as_float(0xff800000);
  for (int j = threadIdx.x; j < V; j += blockDim.x) m = fmaxf(m, x[j]);
  m = block_reduce(m, red, true);
  float s = 0.f;
  for (int j = threadIdx.x; j < V; j += blockDim.x) s += expf(x[j] - m);
  return m + logf(block_reduce(s, red, false));
}

extern "C" __global__ void softmax_ce_fwd(const float *logits,
                                          const float *label, float *loss,
                                          int V) {
  extern __shared__ float red[];
  const float *x = logits + (size_t)blockIdx.x * V;
  const float lse = row_lse(x, V, red);
  if (threadIdx.x == 0) loss[blockIdx.x] = lse - x[(int)label[blockIdx.x]];
}

extern "C" __global__ void softmax_ce_bwd(const float *logits,
                                          const float *label,
                                          const float *out_grad, float *grad,
                                          int V) {
  extern __shared__ float red[];
  const size_t row = blockIdx.x;
  const float *x = logits + row * V;
  float *g = grad + row * V;
  const float lse = row_lse(x, V, red);
  const int y = (int)label[row];
  const float og = out_grad[row];
  for (int j = threadIdx.x; j < V; j += blockDim.x)
    g[j] = (expf(x[j] - lse) - (j == y ? 1.f : 0.f)) * og;
}
"""
CE_FWD_SIG = "const float *logits, const float *label, float *loss, int V"
CE_BWD_SIG = ("const float *logits, const float *label, const float *out_grad,"
              " float *grad, int V")
CE_THREADS = 512
CE_SMEM = CE_THREADS // 32 * 4

# the imperative head: the flagship's output layer at full width over one
# micro-batch of rows (PERF.md section 4)
HEAD = dict(rows=8192, hidden=1024, vocab=16384, steps=10, lr=1.0, seed=21)
# rtc against the plain CustomOp over the 10 steps: about 10x the first
# reading on the card (1.027e-7 and 7.451e-9: f32 sums in two orders)
HEAD_TOL = dict(loss_rel=1e-6, w_abs=1e-7)


def expect_raise(what, fn, exc, needle):
    """``fn()`` must raise ``exc`` with ``needle`` in its message."""
    try:
        fn()
    except exc as e:
        check(needle in str(e), f"{what}: raised without {needle!r}: {e}")
        first = str(e).strip().splitlines()[0][:150]
        print(f"  refused as it must: {what}: {type(e).__name__}: {first}",
              flush=True)
        return
    raise SmokeFailure(f"{what}: did not raise {exc.__name__}")


def phase_k6(torch, mx):
    """rtc against plain versions: saxpy and tile_double on
    ``tests/test_rtc.py``'s numbers, a templated ``axpy<T>`` through its
    exports, dynamic shared memory above 48 KB, the refusals, and saxpy
    driven and timed at 2^26 elements. Returns saxpy's record."""
    import numpy as np
    nd, rtc = mx.nd, mx.rtc
    gpu = mx.gpu(0)
    major, minor = rtc.nvrtc_version()
    print(f"NVRTC {major}.{minor} from {rtc.nvrtc_path()}, target {rtc.ARCH}",
          flush=True)
    mod = rtc.CudaModule(SAXPY_SRC)
    amod = rtc.CudaModule(AXPY_SRC, exports=("axpy<float>", "axpy<double>"))
    print(f"compiled: saxpy module (3 kernels) {mod.compile_seconds:.3f} s, "
          f"axpy module (2 exports) {amod.compile_seconds:.3f} s", flush=True)
    saxpy = mod.get_kernel("saxpy", SAXPY_SIG)

    rs = np.random.RandomState(0)        # tests/test_rtc.py's numbers
    a = np.float32(2.5)
    x_np = rs.randn(16, 128).astype(np.float32)
    y_np = rs.randn(16, 128).astype(np.float32)
    x, y = nd.array(x_np, ctx=gpu), nd.array(y_np, ctx=gpu)
    out = nd.zeros((16, 128), ctx=gpu)
    saxpy.launch([x, y, out, float(a), x.size], gpu, (8,), (256,))
    err = float(np.abs(out.asnumpy() - (a * x_np + y_np)).max())
    check(err <= 1e-6, f"saxpy (16, 128): err {err} (tol 1e-6)")
    print(f"saxpy (16, 128) a=2.5: max_abs_err {err:.3e} (tol 1e-6)",
          flush=True)

    tile = mod.get_kernel("tile_double", TILE_SIG)
    xt_np = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
    xt = nd.array(xt_np, ctx=gpu)
    ot = nd.zeros((32, 128), ctx=gpu)
    tile.launch([xt, ot, 128], gpu, (4, 1, 1), (128, 1, 1))
    check(np.array_equal(ot.asnumpy(), 2 * xt_np), "tile_double != 2 * x")
    print("tile_double (32, 128), grid of 4 (8, 128) tiles: equal to 2 * x",
          flush=True)

    for ctype, dt in (("float", np.float32), ("double", np.float64)):
        k = amod.get_kernel(f"axpy<{ctype}>", f"const {ctype} *x, {ctype} *y, "
                            f"{ctype} alpha, int n")
        xa_np, ya_np = rs.randn(1000).astype(dt), rs.randn(1000).astype(dt)
        xa = nd.array(xa_np, ctx=gpu, dtype=dt.__name__)
        ya = nd.array(ya_np, ctx=gpu, dtype=dt.__name__)
        k.launch([xa, ya, 0.75, 1000], gpu, (4,), (256,))
        err = float(np.abs(ya.asnumpy() - (ya_np + dt(0.75) * xa_np)).max())
        check(err <= 1e-6, f"axpy<{ctype}>: err {err}")
        print(f"axpy<{ctype}> (1000,): y += 0.75 x in place, max_abs_err "
              f"{err:.3e} (tol 1e-6)", flush=True)

    rev = mod.get_kernel("segment_reverse", REVERSE_SIG)
    seg = 16384
    xr_np = rs.randn(3 * seg).astype(np.float32)
    xr = nd.array(xr_np, ctx=gpu)
    orv = nd.zeros((3 * seg,), ctx=gpu)
    rev.launch([xr, orv, seg], gpu, (3,), (1024,), shared_mem=seg * 4)
    want = xr_np.reshape(3, seg)[:, ::-1].reshape(-1)
    check(np.array_equal(orv.asnumpy(), want), "segment_reverse")
    print(f"segment_reverse: 3 blocks with {seg * 4} bytes of dynamic shared "
          "memory each: equal to the reversed segments", flush=True)

    n0 = saxpy.launches
    expect_raise("an export that was not declared",
                 lambda: amod.get_kernel("axpy<int>", "const int *x, int *y, "
                                         "int alpha, int n"),
                 ValueError, "not in exports")
    expect_raise("a name that is not in the module",
                 lambda: mod.get_kernel("no_such_kernel", "int n"),
                 mx.base.MXTPUError, "cuModuleGetFunction")
    expect_raise("a dtype that does not match the signature",
                 lambda: saxpy.launch([x.astype("float64"), y, out, 1.0,
                                       x.size], gpu, (8,), (256,)),
                 TypeError, "must be torch.float32")
    expect_raise("a CPU NDArray",
                 lambda: saxpy.launch([nd.array(x_np, ctx=mx.cpu()), y, out,
                                       1.0, x.size], gpu, (8,), (256,)),
                 ValueError, "CPU NDArray")
    expect_raise("source that does not compile",
                 lambda: rtc.CudaModule('extern "C" __global__ void broken('
                                        'float *x) { x[0] = undefined_name; }'),
                 mx.base.MXTPUError, "undefined_name")
    check(saxpy.launches == n0, "a refused launch was counted")

    # saxpy at 2^26 elements: the drive (its launch count), then the timings
    n = 1 << 26
    g = torch.Generator(device="cuda").manual_seed(5)
    xb = nd.NDArray(torch.randn(n, device="cuda", generator=g))
    yb = nd.NDArray(torch.randn(n, device="cuda", generator=g))
    ob = nd.empty((n,), ctx=gpu)
    grid = ((n + 255) // 256,)
    saxpy.launches = 0
    saxpy.launch([xb, yb, ob, 2.5, n], gpu, grid, (256,))
    launches = saxpy.launches
    err = float((ob.data - (2.5 * xb + yb).data).abs().max())
    check(err <= 1e-6 and launches == 1,
          f"saxpy 2^26: err {err} (tol 1e-6), launches {launches}")
    ms = timed_ms(torch, lambda: saxpy.launch([xb, yb, ob, 2.5, n], gpu, grid,
                                              (256,)), 50)
    plain_ms = timed_ms(torch, lambda: 2.5 * xb + yb, 50)
    xt_, yt_ = xb.data, yb.data
    lib_ms = timed_ms(torch, lambda: torch.add(yt_, xt_, alpha=2.5), 50)
    bound_ms, bound_by = _bound(2.0 * n, 3 * 4 * n, "float32")
    print(f"saxpy 2^26 f32: max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain "
          f"(nd: 2.5 * x + y) {plain_ms:.4f} ms, torch.add(y, x, alpha=2.5) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{3 * 4 * n} bytes)", flush=True)
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def register_ce_ops(mx, fwd, bwd):
    """Two ``CustomOp``s of per-row softmax cross-entropy (logits, float
    labels) -> loss per row: ``rtc_softmax_ce`` launches the
    runtime-compiled kernels ``fwd`` and ``bwd`` (``None`` where there is
    no card); ``plain_softmax_ce`` computes the same with ``nd`` ops."""
    nd, operator = mx.nd, mx.operator

    class _Prop(operator.CustomOpProp):
        def list_arguments(self):
            return ["logits", "label"]

        def list_outputs(self):
            return ["loss"]

        def infer_shape(self, in_shape):
            return in_shape, [[in_shape[0][0]]], []

    class RtcCE(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            logits, label = in_data
            rows, V = logits.shape
            fwd.launch([logits, label, out_data[0], V], logits.context,
                       (rows,), (CE_THREADS,), shared_mem=CE_SMEM)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            logits, label = in_data
            rows, V = logits.shape
            bwd.launch([logits, label, out_grad[0], in_grad[0], V],
                       logits.context, (rows,), (CE_THREADS,),
                       shared_mem=CE_SMEM)

    class PlainCE(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            logits, label = in_data
            self.assign(out_data[0], req[0],
                        -nd.pick(nd.log_softmax(logits), label))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            logits, label = in_data
            g = (nd.softmax(logits) - nd.one_hot(label, logits.shape[1])) \
                * out_grad[0].reshape((-1, 1))
            self.assign(in_grad[0], req[0], g)

    @operator.register("rtc_softmax_ce")
    class RtcProp(_Prop):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return RtcCE()

    @operator.register("plain_softmax_ce")
    class PlainProp(_Prop):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return PlainCE()


def head_data(mx, ctx, rows, hidden, vocab, seed):
    """x (rows, hidden) and float labels below ``vocab`` from ``seed`` on
    ``ctx``, and the initial W (hidden, vocab) as numpy."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x = mx.nd.array(rs.randn(rows, hidden).astype(np.float32), ctx=ctx)
    label = mx.nd.array(rs.randint(0, vocab, rows).astype(np.float32),
                        ctx=ctx)
    w0 = (0.02 * rs.randn(hidden, vocab)).astype(np.float32)
    return x, label, w0


def head_steps(mx, op_type, x, label, W, steps, lr):
    """``steps`` imperative steps of the output layer on the marked array
    ``W``: ``nd.dot``, the ``Custom`` cross-entropy, ``backward``, ``W -=
    lr * W.grad``; one readback at the end. Returns the losses."""
    nd, autograd = mx.nd, mx.autograd
    losses = []
    for _ in range(steps):
        with autograd.record():
            logits = nd.dot(x, W)
            loss = nd.mean(nd.Custom(logits, label, op_type=op_type))
        loss.backward()
        W -= lr * W.grad
        losses.append(loss)
    return [float(v.asscalar()) for v in losses]


def train_head(mx, op_type, x, label, w0, steps, lr, ctx):
    """``head_steps`` from W = ``w0`` (numpy) on ``ctx``. Returns (losses,
    W, seconds of the steps)."""
    W = mx.nd.array(w0, ctx=ctx)
    W.attach_grad()
    t0 = time.monotonic()
    losses = head_steps(mx, op_type, x, label, W, steps, lr)
    return losses, W, time.monotonic() - t0


def phase_head(torch, mx):
    """The flagship's output layer trained imperatively through the rtc
    softmax-CE pair at full width (rows 8192, d1024 -> vocab 16384): the
    learning gate, 10 launches of each kernel, parity with the plain
    ``CustomOp``, then the pair checked and timed on one step's logits
    against its plain version, its bound and ``F.cross_entropy``. Returns
    the two kernels' records."""
    import torch.nn.functional as F
    nd, rtc = mx.nd, mx.rtc
    gpu = mx.gpu(0)
    mod = rtc.CudaModule(CE_SRC)
    print(f"compiled: softmax-CE module (2 kernels) "
          f"{mod.compile_seconds:.3f} s", flush=True)
    fwd = mod.get_kernel("softmax_ce_fwd", CE_FWD_SIG)
    bwd = mod.get_kernel("softmax_ce_bwd", CE_BWD_SIG)
    register_ce_ops(mx, fwd, bwd)
    R, D, V, steps, lr = (HEAD[k] for k in ("rows", "hidden", "vocab",
                                           "steps", "lr"))
    x, label, w0 = head_data(mx, gpu, R, D, V, HEAD["seed"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd.launches = bwd.launches = 0
    losses, W, secs = train_head(mx, "rtc_softmax_ce", x, label, w0, steps,
                                 lr, gpu)
    launches = dict(fwd=fwd.launches, bwd=bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), f"head losses {losses}")
    check(launches == dict(fwd=steps, bwd=steps),
          f"rtc launches {launches}: want {steps} each")
    check(losses[0] - losses[-1] > 0.3,
          f"learning gate: loss {losses[0]:.4f} -> {losses[-1]:.4f} (must "
          "fall by 0.3)")
    plain_losses, plain_W, plain_secs = train_head(
        mx, "plain_softmax_ce", x, label, w0, steps, lr, gpu)
    lrel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    wdiff = float((W.data - plain_W.data).detach().abs().max())
    check(lrel <= HEAD_TOL["loss_rel"] and wdiff <= HEAD_TOL["w_abs"],
          f"rtc vs plain head: losses {losses} vs {plain_losses} (max rel "
          f"{lrel:.3e}, tol {HEAD_TOL['loss_rel']:g}); final W max diff "
          f"{wdiff:.3e} (tol {HEAD_TOL['w_abs']:g})")
    print(f"imperative head rows {R} d{D} -> vocab {V} f32, lr {lr}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps (gate: "
          f"fall by 0.3; uniform {math.log(V):.2f}); wall per step over the "
          f"10 {secs / steps * 1e3:.2f} ms (rtc op, the process's first f32 "
          f"GEMMs of this shape included), {plain_secs / steps * 1e3:.2f} ms "
          f"(plain op, after it); launches {launches}; max_memory_allocated "
          f"{peak} bytes; "
          f"vs the plain CustomOp: losses max rel diff {lrel:.3e} (tol "
          f"{HEAD_TOL['loss_rel']:g}), final W max abs diff {wdiff:.3e} (tol "
          f"{HEAD_TOL['w_abs']:g})", flush=True)
    print(f"  losses {losses}", flush=True)

    # the pair on one step's logits: plain version, bound, library call
    logits = nd.dot(x, W)
    lt, yt = logits.data, label.data
    og = nd.NDArray(torch.full((R,), 1.0 / R, device="cuda"))
    loss_k = nd.zeros((R,), ctx=gpu)
    grad_k = nd.zeros((R, V), ctx=gpu)

    def run_fwd():
        fwd.launch([logits, label, loss_k, V], gpu, (R,), (CE_THREADS,),
                   CE_SMEM)

    def run_bwd():
        bwd.launch([logits, label, og, grad_k, V], gpu, (R,), (CE_THREADS,),
                   CE_SMEM)

    def plain_fwd():
        return -nd.pick(nd.log_softmax(logits), label)

    def plain_bwd():
        return (nd.softmax(logits) - nd.one_hot(label, V)) * og.reshape((-1, 1))

    run_fwd()
    run_bwd()
    ref_f, ref_b = plain_fwd().data, plain_bwd().data
    fwd_err = float((loss_k.data - ref_f).abs().max())
    bwd_err = float((grad_k.data - ref_b).abs().max())
    tol_f = 1e-5 * float(ref_f.abs().max())
    tol_b = 1e-5 * float(ref_b.abs().max())
    check(fwd_err <= tol_f and bwd_err <= tol_b,
          f"softmax-CE kernels vs plain: loss err {fwd_err} (tol {tol_f}), "
          f"grad err {bwd_err} (tol {tol_b})")
    ms_f, ms_b = timed_ms(torch, run_fwd, 20), timed_ms(torch, run_bwd, 20)
    plain_f = timed_ms(torch, plain_fwd, 10)
    plain_b = timed_ms(torch, plain_bwd, 10)
    y_long = yt.long()
    lib_f = timed_ms(torch, lambda: F.cross_entropy(lt, y_long), 20)
    lg = lt.detach().clone().requires_grad_(True)
    lib_fb = timed_ms(torch, lambda: F.cross_entropy(lg, y_long).backward(),
                      20)
    # one step on the trained W, and the device work it is made of: the
    # two f32 GEMMs (logits, W's gradient), the pair, the update
    step_ms = timed_ms(torch, lambda: head_steps(
        mx, "rtc_softmax_ce", x, label, W, 1, lr), 10, warmup=2)
    xt, wt, gt = x.data, W.data.detach(), grad_k.data
    gemm_ms = timed_ms(torch, lambda: torch.matmul(xt, wt), 5)
    dw_ms = timed_ms(torch, lambda: torch.matmul(xt.T, gt), 5)
    upd_ms = timed_ms(torch, lambda: wt - lr * wt, 20)
    device_ms = gemm_ms + dw_ms + ms_f + ms_b + upd_ms
    print(f"imperative step {step_ms:.3f} ms (with its readback): logits "
          f"GEMM {gemm_ms:.3f} ms, W-gradient GEMM {dw_ms:.3f} ms (2 x "
          f"{2.0 * R * D * V:.3e} f32 flops), softmax-CE pair "
          f"{ms_f + ms_b:.3f} ms, update {upd_ms:.3f} ms: device "
          f"{device_ms:.3f} ms = {device_ms / step_ms:.3f} of the step, the "
          f"rest host time and small ops", flush=True)
    elems = R * V
    b_f, by_f = _bound(3.0 * elems, 4 * elems + 8 * R, "float32")
    b_b, by_b = _bound(5.0 * elems, 8 * elems + 12 * R, "float32")
    print(f"softmax-CE pair at ({R}, {V}) f32: loss err {fwd_err:.3e} (tol "
          f"{tol_f:.3e}), grad err {bwd_err:.3e} (tol {tol_b:.3e}); fwd "
          f"{ms_f:.4f} ms + bwd {ms_b:.4f} ms = {ms_f + ms_b:.4f} ms, bound "
          f"{b_f:.4f} + {b_b:.4f} = {b_f + b_b:.4f} ms ({by_f}: 3 x "
          f"{4 * elems} bytes); plain (nd) {plain_f:.4f} + {plain_b:.4f} ms; "
          f"F.cross_entropy fwd {lib_f:.4f} ms, fwd + bwd {lib_fb:.4f} ms",
          flush=True)
    common = dict(route="nvrtc", source="mxtpu_torch/rtc.py",
                  kernel_source="chip_smoke.py:CE_SRC",
                  replaces="mxtpu/rtc.py:47", path="imperative head")
    return [dict(name="rtc softmax_ce_fwd", launches=launches["fwd"],
                 max_abs_err=fwd_err, ms=ms_f, plain_ms=plain_f,
                 bound_ms=b_f, bound_by=by_f, library_ms=lib_f, **common),
            dict(name="rtc softmax_ce_bwd", launches=launches["bwd"],
                 max_abs_err=bwd_err, ms=ms_b, plain_ms=plain_b,
                 bound_ms=b_b, bound_by=by_b, library_ms=lib_fb - lib_f,
                 **common)]


# ---------------------------------------------------------------------------
# phase 15: the vision path
# ---------------------------------------------------------------------------

# (tag, dtype, batch, micro-batches, replays): the JAX package's benchmark
# configurations (bench.py:TRAIN_CONFIGS)
VISION_LEGS = [("fp32_b32", "float32", 32, 1, 20),
               ("bf16_b128", "bfloat16", 128, 1, 20)]
# (name, image size): bench.py:SCORE_MODELS, each at B1 and B32
SCORE_MODELS = [("alexnet", 224), ("resnet50_v1", 224), ("mobilenet1.0", 224),
                ("inceptionv3", 299)]
# a pair that cuDNN does not make bit-equal: each tensor within this share
# of its largest entry
CUDNN_TOL = 5e-5


def vision_batch(torch, B, dtype, size=224, classes=1000, seed=0):
    """A resident synthetic batch on the card from ``seed``: images uniform
    in [0, 1) (the JAX package's benchmark draws ``rand``) and labels."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((B, 3, size, size), generator=g, device="cuda")
    y = torch.randint(0, classes, (B,), generator=g, device="cuda")
    return x.to(getattr(torch, dtype)), y.float()


def resnet50_trainer(mx, vision, parallel, optimizer, loss_mod, dtype, k):
    """``bench_train``'s set-up: ``resnet50_v1(classes=1000)``, the default
    initializer on the card, ``cast``, ``SGD(0.05, momentum 0.9, wd 1e-4)``
    and softmax cross-entropy through ``DataParallelTrainer``; the net's
    shapes stay deferred until the first step. Weights are drawn from seed
    0 at that step, so two trainers built alike start alike."""
    mx.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize()
    if dtype != "float32":
        net.cast(dtype)
    dpt = parallel.DataParallelTrainer(
        net, loss_mod.SoftmaxCrossEntropyLoss(),
        optimizer.SGD(learning_rate=0.05, momentum=0.9, wd=1e-4),
        micro_batches=k)
    return net, dpt


def device_busy(torch, fn, n):
    """``fn`` ``n`` times under ``torch.profiler`` (device activity): the
    device's busy share of the wall, busy µs by device operation and the
    wall µs."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name = {}
    for name, on_device, us in profile_events(torch, prof):
        if on_device:
            by_name[name] = by_name.get(name, 0.0) + us
    return sum(by_name.values()) / wall_us, by_name, wall_us


def _param_kind(name):
    """The op whose backward writes a zoo parameter's gradient."""
    if "conv" in name:
        return "convolution backward (weight gradient)"
    if "batchnorm" in name:
        return "BatchNorm backward (gamma/beta reductions)"
    return "linear backward (weight gradient)"


def unreproducible_grads(torch, loss_mod, net, x, y):
    """The parameters whose gradients differ between two identical
    training-mode forward and backward passes of ``net`` on ``(x, y)``,
    with the op that computes each."""
    loss = loss_mod.SoftmaxCrossEntropyLoss()
    named = [(n, p._tensor()) for n, p in net.collect_params().items()
             if p.grad_req != "null"]
    net.train()
    grads = []
    try:
        for _ in range(2):
            lv = loss(net(x), y).float().mean()
            grads.append(torch.autograd.grad(lv, [t for _, t in named]))
    finally:
        net.eval()
    return [(n, _param_kind(n)) for (n, _), a, b in zip(named, *grads)
            if not torch.equal(a, b)]


def tensor_diffs(torch, a, b, names):
    """Each pair's largest difference over ``b``'s largest entry, largest
    first, with the name."""
    return sorted((((x.float() - y.float()).abs().max().item()
                    / max(y.float().abs().max().item(), 1e-30), n)
                   for n, x, y in zip(names, a, b)), reverse=True)


def replay_vs_eager(torch, net, dpt, x, y):
    """One step of ``dpt``'s captured program (a replay) and, from the
    same weights, running statistics, optimizer states and step count,
    one step of its body run eagerly (``eager_step``). Returns the two
    losses, the parameter names and each side's parameters after its step
    (the trainer is left as the eager step leaves it)."""
    params = net.collect_params()
    names = list(params)
    live = [p._tensor() for p in params.values()] \
        + [s for st in dpt._states for s in st]

    def snap():
        return [t.detach().clone() for t in live]

    def restore(saved):
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)

    before, t = snap(), dpt._t
    replayed_loss = float(dpt.step_async(x, y))
    replayed = snap()[:len(names)]
    restore(before)
    dpt._t = t
    eager_loss = float(dpt.eager_step(x, y))
    eager = snap()[:len(names)]
    return (replayed_loss, eager_loss), names, replayed, eager


def vision_train_leg(torch, mx, vision, parallel, optimizer, loss_mod, tag,
                     dtype, B, k, steps, profile_top):
    """One ``bench_train`` leg (see the module docstring, phase 15 (a));
    with ``profile_top`` also (f), one profiled replay's top operations."""
    x, y = vision_batch(torch, B, dtype)
    net, dpt = resnet50_trainer(mx, vision, parallel, optimizer, loss_mod,
                                dtype, k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loss_start = float(dpt.step_async(x, y))
    first_s = time.monotonic() - t0
    t0 = time.monotonic()
    float(dpt.step_async(x, y))           # captures, then replays
    second_s = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = dpt.step_async(x, y)
    loss_end = float(loss)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated()
    stats = dpt.stats()
    cost = dpt.cost_analysis()
    busy, _, _ = device_busy(torch, lambda: dpt.step_async(x, y), 3)
    check(math.isfinite(loss_start) and math.isfinite(loss_end),
          f"{tag}: losses {loss_start}, {loss_end}")
    check(stats["captured"] == 1 and stats["replays"] == steps + 1,
          f"{tag}: trainer {stats}: want 1 capture and {steps + 1} replays")
    check(loss_end < loss_start - 0.3,
          f"{tag} learning gate: loss {loss_start:.4f} -> {loss_end:.4f} "
          f"(must fall by 0.3)")
    share = cost["flops"] / (step_ms / 1e3) / PEAK_FLOPS[dtype]
    label = "f32 without TF32" if dtype == "float32" else dtype
    print(f"vision (a) {tag}: ResNet-50 v1 {label} B{B} x{k} SGD(0.05, "
          f"momentum 0.9, wd 1e-4), captured: loss {loss_start:.4f} -> "
          f"{loss_end:.4f} over 2 + {steps} steps (gate: fall by 0.3); first "
          f"step (shapes, body, cost count) {first_s:.2f} s; second (capture "
          f"{stats['capture_ms']:.1f} ms, then a replay) {second_s * 1e3:.1f} "
          f"ms; {steps} replays {step_ms:.2f} ms/step = {B / step_ms * 1e3:.1f}"
          f" img/s; captures {stats['captured']}, replays "
          f"{stats['replays']}; device busy {busy:.3f} of 3 replays' wall; "
          f"max_memory_allocated {peak} bytes; cost_analysis flops "
          f"{cost['flops']:.4e} a step ({cost['flops'] / (3 * 4.1e9 * B):.3f}"
          f" x the JAX benchmark's 3 x 4.1 GFLOP an image) = "
          f"{cost['flops'] / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
          f"{share:.4f} of the {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s "
          f"{label} peak", flush=True)
    if profile_top:
        profile_step(torch, dpt, x, y, label=f"vision (f) {tag}")
    (lr_, le), names, replayed, eager = replay_vs_eager(torch, net, dpt, x,
                                                         y)
    if lr_ == le and all(torch.equal(a, b) for a, b in zip(replayed, eager)):
        verdict = f"bit-equal (loss {lr_:.6f})"
    else:
        diffs = tensor_diffs(torch, replayed, eager, names)
        differ = unreproducible_grads(torch, loss_mod, net, x, y)
        kinds = sorted({k for _, k in differ})
        verdict = (
            f"not bit-equal: loss {lr_:.6f} vs {le:.6f}; "
            + ", ".join(f"{d:.3e} in {n}" for d, n in diffs[:3])
            + f" of each tensor's largest entry (tol {CUDNN_TOL:g}); two "
            f"identical eager passes differ in {len(differ)} of "
            f"{len(dpt._params)} gradients, by {kinds}; nearest the loss "
            f"{[n for n, _ in differ[-3:]]}")
        check(diffs[0][0] <= CUDNN_TOL and abs(lr_ - le) <= CUDNN_TOL
              * abs(le) and differ, f"{tag} replay vs body {verdict}")
    print(f"vision (a) {tag}: one replayed step against the body run eagerly "
          f"from the same state: {verdict}", flush=True)
    del net, dpt
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, img_s=B / step_ms * 1e3, busy=busy,
                peak=peak, share=share)


def vision_b512(torch, mx, vision, parallel, optimizer, loss_mod, replays=3):
    """(b) ``bf16_b512x4``: B=512 as 4 micro-batches of 128. The running
    statistics after the captured step (its first replay) equal those of
    an eager step over the same micro-batches from the same state."""
    B, k = 512, 4
    x, y = vision_batch(torch, B, "bfloat16")
    net, dpt = resnet50_trainer(mx, vision, parallel, optimizer, loss_mod,
                                "bfloat16", k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loss0 = float(dpt.step_async(x, y))
    first_s = time.monotonic() - t0
    before = {n: p._tensor().detach().clone()
              for n, p in net.collect_params().items()
              if p.grad_req == "null"}
    # the first replay (capture included) against the body eagerly
    _, names, replayed, eager = replay_vs_eager(torch, net, dpt, x, y)
    pick = [i for i, n in enumerate(names) if n in before]
    aux = [names[i] for i in pick]
    replayed, eager = [replayed[i] for i in pick], [eager[i] for i in pick]
    moved = sum(not torch.equal(a, before[n]) for a, n in zip(replayed, aux))
    if all(torch.equal(a, b) for a, b in zip(replayed, eager)):
        verdict = "bit-equal"
    else:
        diffs = tensor_diffs(torch, replayed, eager, aux)
        verdict = (f"not bit-equal: "
                   + ", ".join(f"{d:.3e} in {n}" for d, n in diffs[:3])
                   + f" of each one's largest entry (tol {CUDNN_TOL:g}; the "
                   f"forward convolutions and BatchNorm reductions)")
        check(diffs[0][0] <= CUDNN_TOL, f"(b) running statistics {verdict}")
    check(moved == len(aux) == 106,
          f"(b): {moved} of {len(aux)} running statistics moved (want all "
          f"106 of ResNet-50's 53 BatchNorms)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        loss = dpt.step_async(x, y)
    loss_end = float(loss)
    step_ms = (time.perf_counter() - t0) / replays * 1e3
    peak = torch.cuda.max_memory_allocated()
    stats = dpt.stats()
    cost = dpt.cost_analysis()
    share = cost["flops"] / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    check(math.isfinite(loss0) and math.isfinite(loss_end)
          and stats["captured"] == 1 and stats["replays"] == replays + 1,
          f"(b): losses {loss0}, {loss_end}, trainer {stats}")
    print(f"vision (b) bf16_b512x4: ResNet-50 v1 bf16 B512 as 4 micro-batches"
          f" of 128: first step {first_s:.2f} s; running statistics after "
          f"the captured step vs an eager step over the same micro-batches "
          f"from the same state: {verdict} ({moved} tensors moved); "
          f"{replays} replays {step_ms:.2f} ms/step = "
          f"{B / step_ms * 1e3:.1f} img/s; loss {loss0:.4f} -> "
          f"{loss_end:.4f}; capture {stats['capture_ms']:.1f} ms; "
          f"max_memory_allocated {peak} bytes; cost_analysis flops "
          f"{cost['flops']:.4e} = {share:.4f} of the 989 TFLOP/s bf16 peak",
          flush=True)
    del net, dpt
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, img_s=B / step_ms * 1e3, peak=peak,
                share=share)


def vision_card_vs_cpu(torch, mx, vision, parallel, optimizer, loss_mod):
    """(c) ``resnet18_v1`` (f32, B=2, 64x64, 10 classes), the same weights
    on the card and on the CPU: predict- and train-mode logits within
    1e-3; one SGD-momentum step: losses within 1e-5, weights and running
    statistics within 5e-5 of each tensor's largest entry or 1 (phase 10's
    bounds)."""
    from mxtpu_torch import convert
    mx.random.seed(3)
    cpu = vision.resnet18_v1(classes=10)
    cpu.initialize(ctx=mx.cpu())
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 3, 64, 64), generator=g)
    y = torch.randint(0, 10, (2,), generator=g).float()
    with torch.no_grad():
        cpu(x)                             # completes the shapes
    arrays = convert.gluon_arrays(cpu)
    gpu = vision.resnet18_v1(classes=10)
    gpu.initialize()
    convert.load_gluon_arrays(gpu, arrays)
    errs = {}
    with torch.no_grad():
        for mode in ("predict", "train"):
            cpu.train(mode == "train")
            gpu.train(mode == "train")
            errs[mode] = (cpu(x) - gpu(x.cuda()).cpu()).abs().max().item()
    cpu.eval()
    gpu.eval()
    check(max(errs.values()) <= 1e-3, f"(c) logits card vs CPU {errs}")
    losses = {}
    for net, dev in ((cpu, "cpu"), (gpu, None)):
        convert.load_gluon_arrays(net, arrays, ctx=mx.cpu() if dev else None)
        dpt = parallel.DataParallelTrainer(
            net, loss_mod.SoftmaxCrossEntropyLoss(),
            optimizer.SGD(learning_rate=0.05, momentum=0.9, wd=1e-4),
            device=dev)
        losses[dev or "cuda"] = dpt.step(x.to(dpt.device), y.to(dpt.device))
    ldiff = abs(losses["cuda"] - losses["cpu"])
    names = list(cpu.collect_params())
    wd = sorted(((_max_diff(torch, [a._tensor()], [b._tensor()])
                  / max(b._tensor().abs().max().item(), 1.0), n)
                 for n, a, b in zip(names, gpu.collect_params().values(),
                                    cpu.collect_params().values())),
                reverse=True)
    check(ldiff <= 1e-5 and wd[0][0] <= 5e-5,
          f"(c) one step card vs CPU: losses {losses} (tol 1e-5), weights "
          f"and running statistics {wd[:3]} (tol 5e-5)")
    print(f"vision (c) card vs CPU, resnet18_v1 f32 B2 64x64 10 classes: "
          f"logits predict {errs['predict']:.3e}, train {errs['train']:.3e} "
          f"(tol 1e-3); one DataParallelTrainer SGD-momentum step: loss card "
          f"{losses['cuda']:.6f} CPU {losses['cpu']:.6f}, diff {ldiff:.3e} "
          f"(tol 1e-5); weights and running statistics max diff "
          + ", ".join(f"{d:.3e} in {n}" for d, n in wd[:3])
          + " of each tensor's largest entry or 1 (tol 5e-5)", flush=True)


def first_differing_layer(torch, net, NDArray, autograd, xb, prog):
    """Where a chained output differs from the per-call one: leaf-layer
    outputs of one per-call forward of ``xb`` against those of the chained
    program's body run eagerly (its first batch); the first layer that
    differs, or None when the eager body equals the per-call forward (the
    graph replay alone differs)."""
    seen = []
    leaves = [m for m in net.modules() if not list(m.children())]
    hooks = [torch.nn.Module.register_forward_hook(
        m, lambda mod, i, o: seen.append((mod.name, o.detach().clone())))
        for m in leaves]
    try:
        with autograd.predict_mode():
            net(NDArray(xb))
        per, seen[:] = list(seen), []
        prog.body()
        body = seen[:len(per)]
    finally:
        for h in hooks:
            h.remove()
    for (name, a), (_, b) in zip(per, body):
        if not torch.equal(a, b):
            return name
    return None


def vision_scoring(torch, mx, vision, serving):
    """(d) ``bench_inference``: each score model, f32, chained through
    ``ChainedPredictor`` (n forwards one captured program) at B1 (n=50)
    and B32 (n=20), then per call after ``hybridize(static_alloc=True)``;
    chained and per-call outputs bit-equal, or the op that differs named
    and the pair within ``CUDNN_TOL``."""
    from mxtpu_torch import autograd
    from mxtpu_torch.ndarray.ndarray import NDArray
    rows = {}
    for name, size in SCORE_MODELS:
        mx.random.seed(0)
        net = vision.get_model(name, classes=1000)
        net.initialize()
        g = torch.Generator(device="cuda").manual_seed(1)
        with autograd.predict_mode():
            net(NDArray(torch.rand((1, 3, size, size), generator=g,
                                   device="cuda")))
        chained = {}
        for B in (1, 32):
            n = 50 if B == 1 else 20
            stack = torch.rand((n, B, 3, size, size), generator=g,
                               device="cuda")
            cp = serving.ChainedPredictor(net, chain=n)
            t0 = time.monotonic()
            cp.predict_stack(stack)          # warm-up, capture, replay
            torch.cuda.synchronize()
            capture_s = time.monotonic() - t0
            t0 = time.perf_counter()
            out = cp.predict_stack(stack)[0].data
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            chained[B] = (stack, out, cp, n, capture_s, n * B / dt)
        net.hybridize(static_alloc=True)
        for B, (stack, out, cp, n, capture_s, chain_img_s) in chained.items():
            with autograd.predict_mode():
                net(NDArray(stack[0]))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                per = [net(NDArray(stack[i])).data for i in range(n)]
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            per = torch.stack(per)
            check(tuple(out.shape) == (n, B, 1000)
                  and bool(torch.isfinite(out).all()),
                  f"(d) {name} B{B}: chained output {tuple(out.shape)}")
            if torch.equal(out, per):
                verdict = "bit-equal"
            else:
                d = (out - per).abs().max().item() / per.abs().max().item()
                layer = first_differing_layer(
                    torch, net, NDArray, autograd, stack[0],
                    cp._program(n, tuple(stack.shape[1:]), stack.dtype))
                verdict = (f"not bit-equal: {d:.3e} of the largest output; "
                           + (f"first differing layer {layer}" if layer else
                              "the eager body equals the per-call forward, "
                              "the graph replay differs"))
                check(d <= CUDNN_TOL, f"(d) {name} B{B}: chained {verdict}")
            rows[f"{name}_b{B}"] = (chain_img_s, n * B / dt)
            print(f"vision (d) {name} f32 B{B} at {size}: chained (n={n}) "
                  f"{chain_img_s:.1f} img/s (first call, capture included, "
                  f"{capture_s:.2f} s), per call after hybridize("
                  f"static_alloc=True) {n * B / dt:.1f} img/s; chained vs "
                  f"per call {verdict}", flush=True)
        del net, chained
        torch.cuda.empty_cache()
    return rows


def vision_zoo_forward(torch, mx, vision):
    """(e) every other ``get_model`` name: built, initialized on the card,
    one predict-mode forward at B1 at its published input size (LeNet:
    28x28x1), output (1, 1000) and finite; ms of that first forward (it
    completes the deferred shapes) and of a second."""
    from mxtpu_torch import autograd
    from mxtpu_torch.ndarray.ndarray import NDArray
    scored = {n for n, _ in SCORE_MODELS}
    ms = []
    for name in sorted(vision._models):
        if name in scored:
            continue
        size = 299 if name.startswith("inception") else \
            28 if name == "lenet" else 224
        mx.random.seed(0)
        net = vision.get_model(name, classes=1000)
        net.initialize()
        x = NDArray(torch.rand((1, 1 if name == "lenet" else 3, size, size),
                               device="cuda"))
        times = []
        with autograd.predict_mode():
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = net(x).data
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        check(tuple(out.shape) == (1, 1000) and bool(torch.isfinite(out)
                                                     .all()),
              f"(e) {name}: output {tuple(out.shape)}")
        ms.append(f"{name} {times[0]:.1f}/{times[1]:.2f}")
        del net, out
    torch.cuda.empty_cache()
    print(f"vision (e) {len(ms)} more zoo nets, f32 B1, output (1, 1000) "
          f"finite; ms of the first forward (deferred shapes) / a second: "
          + ", ".join(ms), flush=True)


def phase_vision(torch, mx, counts):
    """Phase 15: the vision path on the card (see the module docstring).
    Returns the legs' numbers."""
    from mxtpu_torch import optimizer, parallel, serving
    from mxtpu_torch.gluon import loss as loss_mod
    from mxtpu_torch.gluon.model_zoo import vision
    from mxtpu_torch.ops import attention, quant_attention
    out = {}
    counts(0)
    for tag, dtype, B, k, steps in VISION_LEGS:
        out[tag] = vision_train_leg(torch, mx, vision, parallel, optimizer,
                                    loss_mod, tag, dtype, B, k, steps,
                                    profile_top=dtype == "bfloat16")
    out["bf16_b512x4"] = vision_b512(torch, mx, vision, parallel, optimizer,
                                     loss_mod)
    vision_card_vs_cpu(torch, mx, vision, parallel, optimizer, loss_mod)
    out["score"] = vision_scoring(torch, mx, vision, serving)
    vision_zoo_forward(torch, mx, vision)
    launches = dict(attention_launches(attention),
                    K5=quant_attention.dequant_decode.launches)
    check(not any(launches.values()),
          f"phase 15 launched a TPU kernel's port: {launches} (the vision "
          f"path runs none of K1-K5)")
    print(f"vision: no TPU kernel lies on this path: K1-K5 launches "
          f"{launches}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: int8 quantization
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12       # H100 SXM data sheet, dense int8
QUANT = dict(n=8192, chain=60, B=32, calib_batches=4, score={1: 20, 32: 10},
             slice_rows=8, slice_cols=512)
# the reference's bound of a quantized net against its float source
# (tests/test_quantization.py:144): 0.1 x max(1, max |f32|)
QNET_BOUND = 0.1
# (c): card against CPU logits of the quantized resnet18_v1, as a share
# of max(1, max |CPU|)
QCARD_TOL = 2e-2
# (c): a layer's f32 inputs on the two devices that differ by at most this
# share of the input's largest entry differ by rounding (1/39 of a uint8
# step): their codes may differ by one step, never more (the root rule of
# phase 6b); larger input differences lie behind a code that differed in
# an earlier layer
QCODE_ROUND = 1e-4
# (d): the quantized fit's final loss against the float fit's from the
# same seed, relative (mxtpu/quant/train.py:10-11,
# tests/test_quant.py:380-386); it cannot tell int8 products from float
# ones, so (d) also holds one Dense site of the step to int64 arithmetic
QTRAIN_RTOL = 5e-2
# (e): card against CPU, losses, weights and a site's product, as phase 14
# (b)'s weights; SGD-momentum's lr: an activation code that rounds the
# other way on the card moves the gradients, and the weights move with lr
# (at 0.1 the flagship's position table differed by 8.3e-5 after 3 steps)
QSTEP_TOL = 5e-5
QSTEP_LR = 1e-2
# (e): fp8's losses, relative: an e4m3 code that rounds the other way on
# the card moves its value by 1/16 to 1/8 of itself, ~10x an int8 step at
# a row's largest entries (the first step's losses, from equal weights,
# differed by 3.2e-5 and the third's by 1.04e-4 at lr 1e-2). This bound
# alone does not tell fp8 from int8 steps (their losses differ by ~1.4e-4):
# the weights and the site's product do, and the controls show it
QSTEP_FP8_LOSS = 2e-4


def quant_product_pair(torch, smi):
    """(a) ``bench.py``'s ``bench_int8`` body: 60 chained n = 8192 products
    of int8 codes through ``torch._int_mm`` (int32 sums, ``// 1024`` back to
    int8) against the same chain in bf16; TOP/s beside the dense peaks; one
    int8 product equal to int64 arithmetic on a slice."""
    n, iters = QUANT["n"], QUANT["chain"]
    g = torch.Generator(device="cuda").manual_seed(16)
    a8 = torch.randint(-127, 127, (n, n), generator=g, device="cuda",
                       dtype=torch.int8)
    b8 = torch.randint(-127, 127, (n, n), generator=g, device="cuda",
                       dtype=torch.int8)
    # the card's product takes its right operand column-major
    b_cols = b8.t().contiguous().t()
    abf, bbf = a8.to(torch.bfloat16), b8.to(torch.bfloat16)

    def chain_int8():
        acc = a8
        for _ in range(iters):
            acc = torch.floor_divide(torch._int_mm(acc, b_cols), 1024) \
                .to(torch.int8)
        return acc

    def chain_bf16():
        acc = abf
        for _ in range(iters):
            acc = (torch.matmul(acc, bbf) * 1e-3).to(torch.bfloat16)
        return acc

    tops = {}
    for name, fn in (("int8", chain_int8), ("bf16", chain_bf16)):
        ms = timed_ms(torch, fn, 1, warmup=1)
        tops[name] = iters * 2 * n ** 3 / (ms * 1e-3) / 1e12
    r, c = QUANT["slice_rows"], QUANT["slice_cols"]
    got = torch._int_mm(a8, b_cols)[:r, :c].long()
    want = (a8[:r].long()[:, :, None] * b8[:, :c].long()[None]).sum(1)
    check(torch.equal(got, want), "(a) torch._int_mm is not the int64 "
          "product of the codes")
    print(f"quant (a) bench_int8's chain, {iters} x {n}^3: int8 (_int_mm, "
          f"int32 sums, // 1024) {tops['int8']:.1f} TOP/s = "
          f"{tops['int8'] * 1e12 / PEAK_INT8_OPS:.3f} of the 1979 TOP/s "
          f"int8 peak; bf16 {tops['bf16']:.1f} TFLOP/s = "
          f"{tops['bf16'] * 1e12 / PEAK_FLOPS['bfloat16']:.3f} of 989; int8 "
          f"/ bf16 {tops['int8'] / tops['bf16']:.2f}x; rows 0-{r - 1} x "
          f"columns 0-{c - 1} of one product equal int64 arithmetic; {smi}",
          flush=True)
    return tops


def int64_conv(torch, codes, w_q, stride, pad, dilate, groups=1):
    """int64 arithmetic of the convolution of integer ``codes`` (N, C, H, W)
    by ``w_q`` (O, C/g, KH, KW) over zero padding: im2col in int64 and a
    multiply-sum over K in chunks, one group at a time."""
    from mxtpu_torch.ops.quantization import _patches
    O, Cg, kh, kw = w_q.shape
    pt = _patches(codes.long(), (kh, kw), tuple(stride), tuple(pad),
                  tuple(dilate))
    N, C, OH, OW = pt.shape[:4]
    M, Og = N * OH * OW, O // groups
    outs = []
    for gi in range(groups):
        cols = pt[:, gi * Cg:(gi + 1) * Cg].permute(0, 2, 3, 1, 4, 5) \
            .reshape(M, Cg * kh * kw)
        w = w_q[gi * Og:(gi + 1) * Og].reshape(Og, -1).long().t()
        acc = torch.zeros((M, Og), dtype=torch.int64, device=codes.device)
        step = max(1, int(1e9 // (M * Og * 8)))
        for k in range(0, cols.shape[1], step):
            acc += (cols[:, k:k + step, None] * w[None, k:k + step]).sum(1)
        outs.append(acc)
    return torch.cat(outs, 1).reshape(N, OH, OW, O).permute(0, 3, 1, 2)


def _act_codes(torch, x, scale, unsigned):
    """The unshifted activation codes of ``x`` (uint8 in [0, 255] or int8
    in [-127, 127]) as int64."""
    lo, hi = (0, 255) if unsigned else (-127, 127)
    return torch.clamp(torch.round(x * scale), lo, hi).long()


def layer_inputs(torch, net, layers, fn):
    """Each of ``layers``' input on one run of ``fn`` (Gluon pre-hooks)."""
    seen = {}
    hooks = []
    for name, layer in layers.items():
        def hook(block, args, name=name):
            seen[name] = args[0].detach().clone()
        layer.register_forward_pre_hook(hook)
        hooks.append((layer, hook))
    try:
        fn()
    finally:
        for layer, hook in hooks:
            layer._gluon_pre_hooks.remove(hook)
    return seen


def quant_accumulators(torch, qz, q, layers, seen):
    """(b) each chosen layer's int32 accumulator (the call its forward
    makes) against int64 arithmetic of the same codes on the card."""
    out = []
    for name, layer in layers.items():
        x = seen[name]
        s = layer._x_scale(x)
        if isinstance(layer, qz.QuantizedConv2D):
            acc = q.int8_conv_acc(x, layer._w_q, s, layer._stride,
                                  layer._pad, layer._dilate, layer._groups,
                                  layer._unsigned,
                                  layer._zp_corr(tuple(x.shape)))
            want = int64_conv(torch, _act_codes(torch, x, s, layer._unsigned),
                              layer._w_q, layer._stride, layer._pad,
                              layer._dilate, layer._groups)
        else:
            x = x.reshape(x.shape[0], -1)
            acc = q.int8_dense_acc(x, layer._w_q, s, layer._unsigned,
                                   layer._zp_corr)
            codes = _act_codes(torch, x, s, layer._unsigned)
            want = (codes[:, :, None] * layer._w_q.long().t()[None]).sum(1)
        check(acc.dtype == torch.int32 and torch.equal(acc.long(), want),
              f"(b) {name}: the int32 accumulator is not int64 arithmetic "
              f"of the codes")
        out.append(f"{name} {tuple(x.shape)} -> {tuple(acc.shape)} "
                   f"({'uint8' if layer._unsigned else 'int8'})")
    return out


def quant_resnet50(torch, mx, vision, serving, smi, score15):
    """(b) ``resnet50_v1`` at full size with phase 15 (d)'s weights,
    ``quantize_net(quantized_dtype="auto", calib_mode="entropy")`` over 4
    seeded B32 batches, nothing excluded: calibration seconds; int8 logits
    against the float net's on a held-out B32 batch (the reference's
    bound), top-1 agreement; the accumulators of the stem, a strided 1x1,
    a 3x3 and the dense head, and of a strided 3x3 and a depthwise 3x3 at
    a stage's shape, equal int64 arithmetic; the device histogram equal to
    numpy's on one site's input; scoring at B1 and B32, chained and per
    call, bit-equal."""
    from mxtpu_torch import autograd
    from mxtpu_torch.contrib import quantization as qz
    from mxtpu_torch.ndarray.ndarray import NDArray
    from mxtpu_torch.ops import quantization as q
    from mxtpu_torch.quant import calibrate as cal
    import numpy as np
    B = QUANT["B"]
    mx.random.seed(0)
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize()
    g = torch.Generator(device="cuda").manual_seed(1)
    with autograd.predict_mode():
        net(NDArray(torch.rand((1, 3, 224, 224), generator=g,
                               device="cuda")))
    calib = [NDArray(vision_batch(torch, B, "float32", seed=s)[0])
             for s in range(1, 1 + QUANT["calib_batches"])]
    held = vision_batch(torch, B, "float32", seed=100)[0]
    with autograd.predict_mode():
        ref = net(NDArray(held)).data.clone()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    qz.quantize_net(net, quantized_dtype="auto", calib_mode="entropy",
                    calib_data=calib, num_calib_batches=len(calib))
    torch.cuda.synchronize()
    calib_s = time.monotonic() - t0
    twins = [m for m in net.modules() if isinstance(m, qz._QuantizedLayer)]
    convs = [m for m in twins if isinstance(m, qz.QuantizedConv2D)]
    layers = {
        "stem 7x7/2": convs[0],
        "1x1/2": next(m for m in convs if m._w_q.shape[2:] == (1, 1)
                      and tuple(m._stride) == (2, 2)),
        "3x3/1": next(m for m in convs if m._w_q.shape[2:] == (3, 3)),
        "dense head": next(m for m in twins
                           if isinstance(m, qz.QuantizedDense))}

    def held_forward():
        with autograd.predict_mode():
            out["logits"] = net(NDArray(held)).data.clone()
    out = {}
    seen = layer_inputs(torch, net, layers, held_forward)
    qout = out["logits"]
    scale = max(1.0, ref.abs().max().item())
    err = (qout - ref).abs().max().item()
    top1 = (qout.argmax(1) == ref.argmax(1)).float().mean().item()
    check(bool(torch.isfinite(qout).all()) and err <= QNET_BOUND * scale,
          f"(b) int8 resnet50_v1 logits differ from the float net's by "
          f"{err} (bound {QNET_BOUND} x {scale})")
    acc_lines = quant_accumulators(torch, qz, q, layers, seen)
    xq = torch.randint(-127, 128, (B, 64, 56, 56), generator=g,
                       device="cuda", dtype=torch.int8)
    for what, w, stride, groups in (
            ("3x3/2, 64 -> 128", (128, 64, 3, 3), (2, 2), 1),
            ("depthwise 3x3, 64 groups", (64, 1, 3, 3), (1, 1), 64)):
        wq = torch.randint(-127, 128, w, generator=g, device="cuda",
                           dtype=torch.int8)
        got = q.int_conv(xq, wq, stride, (1, 1), (1, 1), groups)
        check(torch.equal(got.long(), int64_conv(torch, xq, wq, stride,
                                                 (1, 1), (1, 1), groups)),
              f"(b) int_conv {what}: not int64 arithmetic")
        acc_lines.append(f"codes {tuple(xq.shape)} {what}")
    x0 = seen["3x3/1"]
    th = x0.abs().max().item()
    same_hist = np.array_equal(
        cal.histogram_like_numpy(x0, 2001, -th, th),
        np.histogram(x0.double().cpu().numpy(), bins=2001,
                     range=(-th, th))[0])
    check(same_hist, "(b) the device histogram differs from np.histogram")
    print(f"quant (b) resnet50_v1 f32 -> quantize_net(auto, entropy) over "
          f"{len(calib)} B{B} batches at 224: {len(twins)} sites "
          f"({sum(t._unsigned for t in twins)} uint8), calibration "
          f"{calib_s:.2f} s (histograms and extremes on the device, counts "
          f"equal to np.histogram on one site's input); held-out B{B} "
          f"logits vs the float net: max diff {err:.4e} = {err / scale:.4e}"
          f" of max(1, max|f32|) = {scale:.4f} (bound {QNET_BOUND}), top-1 "
          f"agreement {top1:.4f}; int32 accumulators equal int64 "
          f"arithmetic: " + "; ".join(acc_lines) + f"; {smi}", flush=True)
    del seen, calib, ref, qout
    rows = {}
    for Bs, n in QUANT["score"].items():
        stack = torch.rand((n, Bs, 3, 224, 224), generator=g, device="cuda")
        cp = serving.ChainedPredictor(net, chain=n)
        t0 = time.monotonic()
        cp.predict_stack(stack)          # warm-up, capture, replay
        torch.cuda.synchronize()
        capture_s = time.monotonic() - t0
        t0 = time.perf_counter()
        chained = cp.predict_stack(stack)[0].data
        torch.cuda.synchronize()
        chain_img_s = n * Bs / (time.perf_counter() - t0)
        with autograd.predict_mode():
            net(NDArray(stack[0]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per = [net(NDArray(stack[i])).data for i in range(n)]
            torch.cuda.synchronize()
            per_img_s = n * Bs / (time.perf_counter() - t0)
        per = torch.stack(per)
        check(tuple(chained.shape) == (n, Bs, 1000)
              and bool(torch.isfinite(chained).all())
              and torch.equal(chained, per),
              f"(b) int8 resnet50_v1 B{Bs}: chained scoring is not bit-equal "
              f"to per-call scoring")
        f32 = (score15 or {}).get(f"resnet50_v1_b{Bs}")
        rows[Bs] = (chain_img_s, per_img_s)
        print(f"quant (b) int8 resnet50_v1 B{Bs}: chained (n={n}) "
              f"{chain_img_s:.1f} img/s (first call, capture included, "
              f"{capture_s:.2f} s), per call {per_img_s:.1f} img/s; chained "
              f"bit-equal to per call; phase 15 (d)'s f32 resnet50_v1 "
              + (f"{f32[0]:.1f} / {f32[1]:.1f} img/s" if f32 else "not run")
              + f"; {smi}", flush=True)
        del stack, cp, chained, per
    del net
    torch.cuda.empty_cache()
    return dict(calib_s=calib_s, err=err / scale, top1=top1, score=rows)


def quant_card_vs_cpu(torch, mx, vision, smi):
    """(c) ``resnet18_v1`` (B2, 64x64, 10 classes) quantized on the card
    and on the CPU from the same weights and calibration data, ``int8`` /
    ``naive`` and ``auto`` / ``entropy``: each site's threshold within one
    histogram bin, logits within ``QCARD_TOL``; the activation codes each
    device's layers compute from their own inputs, counted where they
    differ: one step at most where the inputs differ by rounding
    (``QCODE_ROUND``), the others behind such a code counted apart."""
    from mxtpu_torch import autograd, convert
    from mxtpu_torch.contrib import quantization as qz
    from mxtpu_torch.ndarray.ndarray import NDArray
    from mxtpu_torch.ops import quantization as q
    from mxtpu_torch.quant import calibrate as cal
    mx.random.seed(3)
    base = vision.resnet18_v1(classes=10)
    base.initialize(ctx=mx.cpu())
    g = torch.Generator().manual_seed(16)
    x = torch.rand((2, 3, 64, 64), generator=g)
    calib = [torch.rand((2, 3, 64, 64), generator=g) for _ in range(2)]
    with autograd.predict_mode():
        base(NDArray(x))                   # completes the shapes
    arrays = convert.gluon_arrays(base)
    for dtype, mode in (("int8", "naive"), ("auto", "entropy")):
        th, logits, codes, inputs = {}, {}, {}, {}
        for dev in ("cpu", "cuda"):
            ctx = mx.cpu() if dev == "cpu" else None
            net = vision.resnet18_v1(classes=10)
            net.initialize(ctx=ctx)
            convert.load_gluon_arrays(net, arrays, ctx=ctx)
            batches = [NDArray(c.to(dev)) for c in calib]
            cb = cal.collect_stats(net, qz._walk(net), batches)
            th[dev] = {n: (cb.absmax(n) if mode == "naive"
                           else cb.threshold(n), cb.histogram(n)[1])
                       for n in cb.names()}
            qz.quantize_net(net, quantized_dtype=dtype, calib_mode=mode,
                            calib_data=batches)
            twins = {n: m for n, m in net.named_modules()
                     if isinstance(m, qz._QuantizedLayer)}

            def fwd():
                with autograd.predict_mode():
                    logits[dev] = net(NDArray(x.to(dev))).data.float().cpu()
            seen = layer_inputs(torch, net, twins, fwd)
            codes[dev], inputs[dev] = {}, {}
            for n, m in twins.items():
                xi = seen[n]
                if isinstance(m, qz.QuantizedDense):
                    xi = xi.reshape(xi.shape[0], -1)
                codes[dev][n] = q._quantize_act(
                    xi, m._x_scale(xi), m._unsigned).to(torch.int32).cpu()
                inputs[dev][n] = xi.float().cpu()
        bins = max(abs(th["cuda"][n][0] - t) / (2 * hw / 2001)
                   for n, (t, hw) in th["cpu"].items())
        check(bins <= 1.0, f"(c) {dtype}/{mode}: a threshold differs by "
              f"{bins:.3f} histogram bins between the card and the CPU")
        scale = max(1.0, logits["cpu"].abs().max().item())
        err = (logits["cuda"] - logits["cpu"]).abs().max().item() / scale
        n_codes = sum(c.numel() for c in codes["cpu"].values())
        roots = behind = worst_root = worst_behind = 0
        for n, c in codes["cpu"].items():
            d = (codes["cuda"][n] - c).abs()
            xc = inputs["cpu"][n]
            near = (inputs["cuda"][n] - xc).abs() \
                <= QCODE_ROUND * xc.abs().max()
            roots += int(((d > 0) & near).sum())
            behind += int(((d > 0) & ~near).sum())
            if bool(near.any()):
                worst_root = max(worst_root, int(d[near].max()))
            worst_behind = max(worst_behind, int(d.max()))
        check(worst_root <= 1 and err <= QCARD_TOL,
              f"(c) {dtype}/{mode}: logits card vs CPU {err:.3e} of max(1, "
              f"max|CPU|) (tol {QCARD_TOL}); {roots} activation codes "
              f"differ where the inputs differ by rounding, the largest by "
              f"{worst_root} steps (at most 1)")
        print(f"quant (c) resnet18_v1 B2 64x64, quantize_net({dtype}, {mode})"
              f" card vs CPU: {len(codes['cpu'])} sites, thresholds within "
              f"{bins:.4f} of a histogram bin; logits {err:.4e} of max(1, "
              f"max|CPU|) (tol {QCARD_TOL}); of {n_codes} activation codes "
              f"{roots} differ where the inputs differ by rounding (each by "
              f"one step) and {behind} behind them (up to {worst_behind} "
              f"steps); {smi}", flush=True)


@contextlib.contextmanager
def quant_site_probe():
    """The first quantized Dense and the first quantized Conv site of the
    step body, as the last eager run and the capture of the body saw them:
    ``{(kind, captured): (x, w, y, kw)}``, the operands and the product of
    ``quant.train``'s ``quant_dense``/``quant_conv`` (wrapped for the
    block; ``quant_scope`` looks them up on each run of the body). A site
    is known by its weight's address, which a captured program keeps. A
    capture runs nothing: the clones it makes live in its pool, and each
    replay writes them, so they hold the last replay's values."""
    import torch
    from mxtpu_torch.quant import train as qt
    seen, first = {}, {}
    orig = {"dense": qt.quant_dense, "conv": qt.quant_conv}

    def wrap(kind):
        def probe(x, w, **kw):
            y = orig[kind](x, w, **kw)
            if first.setdefault(kind, w.data_ptr()) == w.data_ptr():
                cap = x.is_cuda and torch.cuda.is_current_stream_capturing()
                seen[kind, cap] = (x.detach().clone(), w.detach().clone(),
                                   y.detach().clone(), kw)
            return y
        return probe
    qt.quant_dense, qt.quant_conv = wrap("dense"), wrap("conv")
    try:
        yield seen
    finally:
        qt.quant_dense, qt.quant_conv = orig["dense"], orig["conv"]


def int8_site_exact(torch, site, rows=64):
    """(d) a quantized Dense site of the step against int64 arithmetic:
    ``rows`` rows of its input quantized per row (``kv_quant``), their
    int8 products with the weight's per-channel codes summed in int64 on
    the host, rescaled as ``_int8_matmul`` does. Returns whether that
    equals the site's output bit for bit, the rows, and the float product
    of the same operands' largest difference from the output and whether
    it too is bit-equal (the control: a float step fails this check)."""
    from mxtpu_torch.quant import kv_quant
    x, w, y, _ = site
    x2, y2 = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
    pick = torch.arange(0, x2.shape[0], max(1, x2.shape[0] // rows),
                        device=x.device)
    h_q, h_s = kv_quant.quantize_rows(x2[pick], "int8")
    w_q, w_s = kv_quant.quantize_rows(w, "int8")
    acc = h_q.long().cpu() @ w_q.long().cpu().t()
    want = (acc.to(x.device).float() * h_s[:, None] * w_s[None, :]) \
        .to(y.dtype)
    got = y2[pick]
    fl = torch.matmul(x2[pick], w.t()).to(y.dtype)
    float_gap = (fl.float() - got.float()).abs().max().item()
    exact = torch.equal(got, want) and acc.abs().max().item() < 2 ** 31
    return exact, len(pick), float_gap, torch.equal(fl, got)


def flagship_module(torch, mx, lm, io, x, y):
    """Phase 14 (a)'s set-up from a seed: ``Module(flagship)``, Xavier,
    bf16, over one batch."""
    B = MODULE["B"]
    mx.random.seed(16)
    net = lm.transformer_lm("flagship", vocab_size=MODULE["vocab"])
    mod = mx.mod.Module(net)
    it = io.NDArrayIter(x, y, batch_size=B)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    net.cast("bfloat16")
    return net, mod, it


def quant_train_flagship(torch, mx, lm, attention, step_cache, counts, smi):
    """(d) phase 14 (a)'s ``Module.fit`` (flagship, bf16, Adam 3e-4, B8
    T1024, 12 steps) under ``MXTPU_QUANT_STEP=int8``: one capture then
    replays, 48 staged sites, the learning gate, the final loss within
    ``QTRAIN_RTOL`` of the float fit's from the same seed (run here); the
    first Dense site's output in the last replay bit-equal to int64
    arithmetic of its codes (:func:`int8_site_exact`); then a flip to fp8
    and back builds one program and hits. Returns the attention kernels'
    launches in the int8 fit."""
    import numpy as np
    from mxtpu_torch import io, profiler
    B, T, V = MODULE["B"], MODULE["T"], MODULE["vocab"]
    epochs = MODULE["epochs"]
    rs = np.random.RandomState(0)
    x = rs.randint(0, V, (B, T)).astype(np.int32)
    y = rs.randint(0, V, (B, T)).astype(np.float32)
    net, mod, it = flagship_module(torch, mx, lm, io, x, y)
    ref_losses, ref_ms = module_fit(torch, mx, mod, it, epochs, "adam",
                                    {"learning_rate": 3e-4})
    ref_med = float(np.median(ref_ms[2:]))
    del net, mod
    torch.cuda.empty_cache()
    net, mod, it = flagship_module(torch, mx, lm, io, x, y)
    L = len(net.blocks)
    os.environ["MXTPU_QUANT_STEP"] = "int8"
    try:
        step_cache.reset_stats("module_step")
        profiler.reset_quant_stats()
        counts(0)
        with quant_site_probe() as seen:
            losses, step_ms = module_fit(torch, mx, mod, it, epochs, "adam",
                                         {"learning_rate": 3e-4})
        launches = attention_launches(attention)
        sites = profiler.get_quant_stats()["matmuls"]
        cache = step_cache.snapshot()["module_step"]
        st = mod._step_exec.stats()
        want = L * epochs
        check(all(math.isfinite(v) for v in losses),
              f"(d) quantized losses {losses}")
        check(cache == {"hits": epochs - 1, "traces": 1, "retraces": 0}
              and st["programs"] == 1 and st["captured"] == 1
              and st["replays"] == epochs - 1,
              f"(d) step program: module_step {cache}, {st}: want one "
              f"program, captured once, {epochs - 1} replays")
        check(sites == 6 * L,
              f"(d) {sites} quantized sites staged, want 6 x {L} (the JAX "
              f"package's count: tests/test_torch_quant_train.py)")
        check(all(launches[k] == want for k in ("K1_sm90", "K2_sm90",
                                                "K3_sm90")),
              f"(d) launches {launches}: want K1-K3 {want} each on sm90")
        check(losses[-1] < losses[0] - 0.3,
              f"(d) learning gate: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (must fall by 0.3)")
        rel = abs(losses[-1] - ref_losses[-1]) / ref_losses[-1]
        check(rel <= QTRAIN_RTOL,
              f"(d) final loss {losses[-1]:.4f} vs the float fit's "
              f"{ref_losses[-1]:.4f}: {rel:.4f} relative (tol "
              f"{QTRAIN_RTOL})")
        check(("dense", True) in seen,
              "(d) no quantized Dense site ran in the captured step")
        site = seen["dense", True]
        exact, n_rows, float_gap, float_same = int8_site_exact(torch, site)
        check(exact and not float_same,
              f"(d) the first Dense site's output in the last replay is not "
              f"int64 arithmetic of its int8 codes (or the float product "
              f"gives the same bits: {float_same})")
        site_shape = tuple(site[0].shape), tuple(site[1].shape)
        med = float(np.median(step_ms[2:]))
        batch = next(iter(io.NDArrayIter(x, y, batch_size=B)))
        for mode in ("fp8", "int8"):
            os.environ["MXTPU_QUANT_STEP"] = mode
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        flip = step_cache.snapshot()["module_step"]
        check(flip["traces"] == 2 and flip["hits"] == epochs
              and mod._step_exec.stats()["programs"] == 2,
              f"(d) fp8 and back: module_step {flip}, "
              f"{mod._step_exec.stats()}: want one more program, then a hit")
    finally:
        os.environ.pop("MXTPU_QUANT_STEP", None)
    print(f"quant (d) Module(flagship bf16 d{net._units} L{L}).fit(B{B} "
          f"T{T}, adam 3e-4, {epochs} epochs) under MXTPU_QUANT_STEP=int8: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, the float fit's from "
          f"the same seed {ref_losses[0]:.4f} -> {ref_losses[-1]:.4f} "
          f"({rel:.4f} relative, tol {QTRAIN_RTOL}); {sites} quantized sites "
          f"staged; one capture ({st['capture_ms']:.1f} ms), {st['replays']}"
          f" replays; the first Dense site (x {site_shape[0]}, w "
          f"{site_shape[1]}) in the last replay: {n_rows} rows bit-equal to "
          f"int64 arithmetic of the int8 codes, rescaled; the float product "
          f"of the same operands differs by up to {float_gap:.4e}; median "
          f"of the last 10 {med:.2f} ms/step = {B * T / med * 1e3:.1f} "
          f"tokens/s against the float fit's {ref_med:.2f} ms; fp8 and "
          f"back: module_step {flip}; launches {launches}; {smi}",
          flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}; float "
          f"{[round(v, 4) for v in ref_losses]}; ms/step "
          f"{[round(v, 2) for v in step_ms]}", flush=True)
    # the probe's clones go with the programs that write them
    del net, mod, seen, site
    torch.cuda.empty_cache()
    return launches


def site_product(torch, kind, site, mode):
    """(e) ``mode``'s product (None: the float one) of a probed site's
    operands, on the CPU: ``quant.train``'s ``quant_dense``/``quant_conv``
    as the CPU's step runs them."""
    import torch.nn.functional as F
    from mxtpu_torch.quant import train as qt
    x, w, _, kw = site
    x, w = x.cpu(), w.cpu()
    cfg = {k: v for k, v in kw.items() if k not in ("mode", "record")}
    with torch.no_grad():
        if kind == "dense":
            return (qt.quant_dense(x, w, mode=mode, record=False) if mode
                    else torch.matmul(x, w.t()))
        return (qt.quant_conv(x, w, mode=mode, record=False, **cfg) if mode
                else F.conv2d(x, w, None, **cfg))


def step_readings(torch, card, cpu, mode, kinds):
    """(e) a card run against a CPU run under ``mode``: the losses' largest
    difference of max(|CPU|, 1), the weights' (:func:`weight_diffs`), and
    for each site kind the card step's product against ``mode``'s product
    of the same operands on the CPU, of max(largest entry, 1) (None where
    the card's step ran no such quantized site). Then the parts that fail
    ``QSTEP_TOL`` (fp8's losses: ``QSTEP_FP8_LOSS``)."""
    ldiff = max(abs(a - b) / max(abs(b), 1.0)
                for a, b in zip(card["losses"], cpu["losses"]))
    wd = weight_diffs(torch, card["net"], cpu["net"])
    sites = {}
    for kind in kinds:
        # the capture's clones once a replay wrote them, else the last
        # eager run's (a one-step fit on the card, every step on the CPU)
        site = card["seen"].get((kind, True)) if card["replayed"] else None
        site = card["seen"].get((kind, False)) if site is None else site
        if site is None:
            sites[kind] = None
            continue
        want = site_product(torch, kind, site, mode)
        sites[kind] = ((site[2].cpu().float() - want.float()).abs().max()
                       .item() / max(want.abs().max().item(), 1.0))
    ltol = QSTEP_FP8_LOSS if mode == "fp8" else QSTEP_TOL
    fails = ([f"losses {ldiff:.3e} > {ltol}"] if ldiff > ltol else []) \
        + ([f"weights {wd[0][0]:.3e} > {QSTEP_TOL}"]
           if wd[0][0] > QSTEP_TOL else []) \
        + [f"{k} site " + ("not quantized" if d is None
                           else f"{d:.3e} > {QSTEP_TOL}")
           for k, d in sites.items() if d is None or d > QSTEP_TOL]
    return dict(ldiff=ldiff, ltol=ltol, wd=wd, sites=sites, fails=fails)


def quant_step_card_vs_cpu(torch, mx, lm, smi, tmp):
    """(e) card against CPU under the quantized step: the flagship at 2
    layers (f32, B2 T256), 3 SGD-momentum steps (lr ``QSTEP_LR``) under
    ``int8`` and ``fp8``; one ``int8`` step of a small conv net
    (``quant_conv``). The card's run in the CPU's mode: losses and weights
    within ``QSTEP_TOL`` x max(largest entry, 1) (fp8's losses
    ``QSTEP_FP8_LOSS``), and the product of the card step's first
    quantized site of each kind within ``QSTEP_TOL`` of the mode's product
    of the same operands on the CPU (:func:`step_readings`). Controls:
    the card's runs in each other mode (and with the mode off) against
    the same CPU run must fail that check."""
    import numpy as np
    from mxtpu_torch import io
    from mxtpu_torch.gluon import nn
    V = MODULE["vocab"]
    gpu = mx.gpu(0)
    rs = np.random.RandomState(16)
    xb = rs.randint(0, V, (6, 256)).astype(np.int32)
    yb = rs.randint(0, V, (6, 256)).astype(np.float32)
    f = os.path.join(tmp, "q.params")
    card = lm.transformer_lm("flagship", vocab_size=V, num_layers=2)
    card.initialize(mx.init.Xavier(), ctx=gpu)
    card.save_parameters(f)
    del card

    def conv_net(ctx):
        net = nn.HybridSequential(prefix="qconv_")
        with net.name_scope():
            net.add(nn.Conv2D(16, 3, padding=1, in_channels=3,
                              activation="relu"),
                    nn.Conv2D(32, 3, strides=2, padding=1, in_channels=16),
                    nn.Flatten(), nn.Dense(10, in_units=32 * 16 * 16))
        net.initialize(mx.init.Xavier(), ctx=ctx)
        return net

    fc = os.path.join(tmp, "qconv.params")
    mx.random.seed(16)
    conv_net(mx.cpu()).save_parameters(fc)
    g = torch.Generator().manual_seed(16)
    xc = torch.rand((4, 3, 32, 32), generator=g).numpy()
    yc = torch.randint(0, 10, (4,), generator=g).float().numpy()
    # (what, data, labels, batch, the CPU's modes, site kinds)
    legs = [("flagship L2 f32 B2 T256, 3 steps", xb, yb, 2, ("int8", "fp8"),
             ("dense",)),
            ("conv net B4 32x32, 1 step", xc, yc, 4, ("int8",),
             ("conv", "dense"))]

    def fit(x, y, batch, ctx, device, mode, probe):
        if mode:
            os.environ["MXTPU_QUANT_STEP"] = mode
        else:
            os.environ.pop("MXTPU_QUANT_STEP", None)
        if x is xb:
            net = lm.transformer_lm("flagship", vocab_size=V, num_layers=2,
                                    device=device)
            net.load_parameters(f)
        else:
            net = conv_net(ctx)
            net.load_parameters(fc, ctx=ctx)
        m = mx.mod.Module(net, context=ctx)
        it = io.NDArrayIter(x, y, batch_size=batch)
        with (quant_site_probe() if probe else contextlib.nullcontext()) \
                as seen:
            losses = module_fit(torch, mx, m, it, 1, "sgd",
                                {"learning_rate": QSTEP_LR,
                                 "momentum": 0.9})[0]
        # the probe's capture clones hold a replay's values only if one ran
        return dict(losses=losses, net=net, seen=seen or {},
                    replayed=len(losses) > 1)

    try:
        for what, x, y, batch, modes, kinds in legs:
            cards = {m: fit(x, y, batch, gpu, None, m, True)
                     for m in ("int8", "fp8", None)}
            for mode in modes:
                cpu = fit(x, y, batch, mx.cpu(), "cpu", mode, False)
                for run_mode, c in cards.items():
                    r = step_readings(torch, c, cpu, mode, kinds)
                    sites = ", ".join(
                        f"{k} site " + ("not quantized" if d is None
                                        else f"{d:.3e}")
                        for k, d in r["sites"].items())
                    if run_mode == mode:
                        check(not r["fails"],
                              f"(e) {what} under {mode}, card vs CPU: "
                              f"{r['fails']} (losses {c['losses']} vs "
                              f"{cpu['losses']}, weights {r['wd'][:3]})")
                        print(f"quant (e) {what} under MXTPU_QUANT_STEP="
                              f"{mode}, card vs CPU: losses {c['losses']} "
                              f"vs {cpu['losses']}, max diff "
                              f"{r['ldiff']:.3e} of max(|CPU|, 1) (tol "
                              f"{r['ltol']}); weights max diff of each "
                              f"tensor's largest entry or 1 "
                              + ", ".join(f"{d:.3e} in {n}"
                                          for d, n in r["wd"][:2])
                              + f"; the card step's first quantized "
                              f"{sites} of the {mode} product of its "
                              f"operands on the CPU (tol {QSTEP_TOL}); "
                              f"{smi}", flush=True)
                    else:
                        check(bool(r["fails"]),
                              f"(e) control: the card's {what} run with "
                              f"the mode {run_mode or 'off'} passed the "
                              f"check against the CPU's {mode} run "
                              f"(losses {r['ldiff']:.3e}, weights "
                              f"{r['wd'][0][0]:.3e}, {sites})")
                        print(f"quant (e) control: the card's run with the "
                              f"mode {run_mode or 'off'} against the CPU's "
                              f"{mode} run fails the check: losses "
                              f"{r['ldiff']:.3e}, weights "
                              f"{r['wd'][0][0]:.3e}, {sites}; failing: "
                              + "; ".join(r["fails"]), flush=True)
                del cpu
            del cards
    finally:
        os.environ.pop("MXTPU_QUANT_STEP", None)
    torch.cuda.empty_cache()


def phase_quant(torch, mx, counts, smi, score15=None):
    """Phase 16: int8 quantization on the card (see the module docstring).
    Returns the attention kernels' launches in (d)'s quantized fit."""
    import tempfile
    from mxtpu_torch import serving, step_cache
    from mxtpu_torch.gluon.model_zoo import transformer as lm
    from mxtpu_torch.gluon.model_zoo import vision
    from mxtpu_torch.ops import attention
    tmp = tempfile.mkdtemp(prefix="phase16_")
    quant_product_pair(torch, smi)
    torch.cuda.empty_cache()
    quant_resnet50(torch, mx, vision, serving, smi, score15)
    quant_card_vs_cpu(torch, mx, vision, smi)
    launches = quant_train_flagship(torch, mx, lm, attention, step_cache,
                                    counts, smi)
    quant_step_card_vs_cpu(torch, mx, lm, smi, tmp)
    return launches


# ---------------------------------------------------------------------------
# phase 17: recurrent nets, control flow and jit
# ---------------------------------------------------------------------------

# the JAX package's bench_word_lm (bench.py:361): the reference's word LM
# (--large), a resident batch, SGD(1.0, momentum 0.9)
WORD_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, T=35, B=128,
               steps=30, drop_steps=4)
# (b): card against CPU, phase 13's bounds: logits and states within 1e-5 x
# max(|CPU|, 1), weights after one step within 5e-5 of each tensor's
# largest entry
RNN_FWD_TOL = 1e-5
RNN_STEP_TOL = 5e-5
# (c): examples/train_word_lm.py at tests/test_examples.py:21-27's config;
# the gate is that test's
BPTT = dict(vocab=60, corpus_len=12000, branch=4, epochs=4, embed=48,
            hidden=48, layers=2, batch=8, bptt=16, lr=4.0, clip=0.25,
            ppl_gate=20.0)
# (d): foreach over an LSTMCell against rnn_scan (the scan hoists the input
# product and adds both biases there: another order of the same f32 sums)
FOREACH_TOL = 1e-6


def make_corpus(vocab, length, branch=4, seed=17):
    """``examples/train_word_lm.py``'s corpus: a first-order Markov chain,
    every token with ``branch`` fixed successors (numpy only)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    successors = rs.randint(vocab, size=(vocab, branch))
    data = np.empty(length, np.int64)
    data[0] = rs.randint(vocab)
    draws = rs.randint(branch, size=length)
    for t in range(1, length):
        data[t] = successors[data[t - 1], draws[t]]
    return data


def batchify(data, batch_size):
    """(len,) tokens -> (batch, T) parallel streams."""
    n = len(data) // batch_size
    return data[:n * batch_size].reshape(batch_size, n)


def word_lm_net(gluon, c, dropout=0.0):
    """``bench_word_lm``'s net: Embedding -> LSTM (TNC) -> Dense, inside
    its ``LMWrap``, which takes (N, T) tokens, transposes them to (T, N)
    in its forward and returns (T * N, V) logits."""
    V = c["vocab"]

    class LMBlock(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="lm_")
            with self.name_scope():
                self.embedding = gluon.nn.Embedding(V, c["embed"])
                self.lstm = gluon.rnn.LSTM(
                    c["hidden"], num_layers=c["layers"], layout="TNC",
                    input_size=c["embed"], dropout=dropout)
                self.decoder = gluon.nn.Dense(V, in_units=c["hidden"],
                                              flatten=False)

        def forward(self, x):
            return self.decoder(self.lstm(self.embedding(x)))

    class LMWrap(gluon.HybridBlock):
        def __init__(self, inner):
            super().__init__(prefix="wrap_")
            self.inner = inner

        def forward(self, x):
            return self.inner(x.t()).reshape(-1, V)

    return LMWrap(LMBlock())


def word_lm_flops(c):
    """One forward's FLOPs: 2 T B 4H (I + H) a layer, then the decoder's
    2 T B H V; a training step is ~3 of them."""
    T, B, H = c["T"], c["B"], c["hidden"]
    lstm = sum(2 * T * B * 4 * H * ((c["embed"] if i == 0 else H) + H)
               for i in range(c["layers"]))
    return lstm + 2 * T * B * H * c["vocab"]


def word_lm_batch(torch, c):
    """``bench_word_lm``'s resident batch: (N, T) int32 tokens from
    RandomState(0) and their next tokens flattened T-major."""
    import numpy as np
    rs = np.random.RandomState(0)
    tok = rs.randint(0, c["vocab"], (c["T"], c["B"])).astype(np.int32)
    y = np.roll(tok, -1, axis=0).reshape(-1).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(tok.T)).cuda(),
            torch.from_numpy(y).cuda())


def two_replays(torch, net, dpt, x, y, advance):
    """Two steps of ``dpt``'s captured program from the same weights and
    optimizer states; the second at the next ``t`` when ``advance``, else
    at the same. Returns both losses (the trainer is left after the
    second)."""
    live = [p._tensor() for p in net.collect_params().values()] \
        + [s for st in dpt._states for s in st]
    saved = [t.detach().clone() for t in live]
    t0 = dpt._t
    a = float(dpt.step_async(x, y))
    with torch.no_grad():
        for t, v in zip(live, saved):
            t.copy_(v)
    if not advance:
        dpt._t = t0
    b = float(dpt.step_async(x, y))
    return a, b


def word_lm_trainer(mx, gluon, parallel, optimizer, loss_mod, c, dropout):
    """``bench_word_lm``'s net on the card (``Uniform`` from seed 0) and its
    ``DataParallelTrainer``, which must seed the LSTM's dropout."""
    mx.random.seed(0)
    net = word_lm_net(gluon, c, dropout)
    net.initialize()
    dpt = parallel.DataParallelTrainer(
        net, loss_mod.SoftmaxCrossEntropyLoss(),
        optimizer.SGD(learning_rate=1.0, momentum=0.9))
    check(dpt._dropouts == [net.inner.lstm],
          f"word LM: the trainer seeds {dpt._dropouts}, not the LSTM")
    return net, dpt


def word_lm_train(torch, mx, gluon, parallel, optimizer, loss_mod, smi):
    """(a) the word LM at full width; returns its readings."""
    c = WORD_LM
    x, y = word_lm_batch(torch, c)
    net, dpt = word_lm_trainer(mx, gluon, parallel, optimizer, loss_mod, c,
                               0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # what earlier phases hold
    t0 = time.monotonic()
    loss_start = float(dpt.step_async(x, y))
    first_s = time.monotonic() - t0
    t0 = time.monotonic()
    float(dpt.step_async(x, y))           # captures, then replays
    second_s = time.monotonic() - t0
    steps = c["steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = dpt.step_async(x, y)
    loss_end = float(loss)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() - held
    stats = dpt.stats()
    cost = dpt.cost_analysis()
    busy, by_op, _ = device_busy(torch, lambda: dpt.step_async(x, y), 3)
    check(math.isfinite(loss_start) and math.isfinite(loss_end),
          f"word LM (a): losses {loss_start}, {loss_end}")
    check(stats["captured"] == 1 and stats["replays"] == steps + 1,
          f"word LM (a): trainer {stats}: want 1 capture and {steps + 1} "
          f"replays")
    check(loss_end < loss_start - 0.1,
          f"word LM (a) learning gate: loss {loss_start:.4f} -> "
          f"{loss_end:.4f} (bench.py's gate: fall by 0.1)")
    fwd = word_lm_flops(c)
    step_flops = 3 * fwd
    share = step_flops / (step_ms / 1e3) / PEAK_FLOPS["float32"]
    bound_ms = step_flops / PEAK_FLOPS["float32"] * 1e3
    tok_s = c["T"] * c["B"] / step_ms * 1e3
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    total_us = sum(by_op.values())
    print(f"rnn (a) [{smi}]: word LM (bench_word_lm) Embedding(10000, 650) "
          f"-> LSTM(650, 2 layers, TNC) -> Dense(10000), T35 B128 f32 "
          f"(TF32 off), SGD(1.0, momentum 0.9), DataParallelTrainer, "
          f"captured: loss {loss_start:.4f} -> {loss_end:.4f} over 2 + "
          f"{steps} steps (gate: fall by 0.1); first step (body, cost count) "
          f"{first_s:.2f} s; second (capture {stats['capture_ms']:.1f} ms, "
          f"then a replay) {second_s * 1e3:.1f} ms; {steps} replays "
          f"{step_ms:.3f} ms/step = {tok_s:.1f} tokens/s; captures "
          f"{stats['captured']}, replays {stats['replays']}; device busy "
          f"{busy:.3f} of 3 replays' wall; peak memory {peak} bytes above "
          f"the {held} earlier phases hold; FLOPs a step 3 x {fwd / 1e9:.2f} G = "
          f"{step_flops / 1e9:.1f} G (cost_analysis {cost['flops'] / 1e9:.1f}"
          f" G) = {step_flops / (step_ms / 1e3) / 1e12:.2f} TFLOP/s = "
          f"{share:.4f} of 67 TFLOP/s f32; bound {bound_ms:.3f} ms; top "
          f"device ops (share of busy): "
          + "; ".join(f"{n[:60]} {us / total_us:.3f}" for n, us in top),
          flush=True)
    (lr_, le), names, replayed, eager = replay_vs_eager(torch, net, dpt, x, y)
    same = lr_ == le and all(torch.equal(a, b)
                             for a, b in zip(replayed, eager))
    check(same, f"word LM (a): a replayed step is not bit-equal to its body "
          f"run eagerly from the same state: loss {lr_} vs {le}; "
          f"{tensor_diffs(torch, replayed, eager, names)[:3]}")
    a, b = two_replays(torch, net, dpt, x, y, advance=True)
    check(a == b, f"word LM (a): without dropout, replays at t and t + 1 "
          f"from one state differ: {a} vs {b}")
    print(f"rnn (a): one replayed step bit-equal to its body run eagerly "
          f"(loss {lr_:.6f}); without dropout two replays from one state at "
          f"t and t + 1 give {a:.6f} and {b:.6f}", flush=True)
    yard = cudnn_yardstick(torch, net, c, smi)
    del net, dpt
    torch.cuda.empty_cache()

    # the dropout leg: the between-layer masks come from the step's seeds
    net, dpt = word_lm_trainer(mx, gluon, parallel, optimizer, loss_mod, c,
                               0.5)
    losses = [float(dpt.step_async(x, y)) for _ in range(2 + c["drop_steps"])]
    a, b = two_replays(torch, net, dpt, x, y, advance=True)
    a2, b2 = two_replays(torch, net, dpt, x, y, advance=False)
    stats = dpt.stats()
    check(all(map(math.isfinite, losses)) and stats["captured"] == 1
          and a != b and a2 == b2,
          f"word LM (a) dropout 0.5: losses {losses}, trainer {stats}; two "
          f"replays from one state at t and t + 1: {a} vs {b} (masks must "
          f"differ); at t twice: {a2} vs {b2} (must be equal)")
    print(f"rnn (a) dropout 0.5 between the layers: {len(losses)} steps "
          f"{[round(v, 4) for v in losses]}; two replays from one state at t "
          f"and t + 1: {a:.6f} vs {b:.6f} (new masks), at t twice: {a2:.6f} "
          f"and {b2:.6f} (the same masks); trainer {stats}", flush=True)
    del net, dpt
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, tok_s=tok_s, busy=busy, peak=peak,
                share=share, bound_ms=bound_ms, **yard)


def cudnn_yardstick(torch, net, c, smi):
    """One LSTM layer at (a)'s shape, forward and backward: the port's
    ``rnn_scan`` (eager, and captured) beside ``torch.nn.LSTM`` (cuDNN)
    with the same weights. A yardstick for a later PR, not on the path."""
    from mxtpu_torch.ops import rnn as ops_rnn
    from mxtpu_torch.step_cache import GraphProgram
    T, B, E, H = c["T"], c["B"], c["embed"], c["hidden"]
    w = [t.detach() for t in net.inner.lstm._weights(E)[0][0]]
    ref = torch.nn.LSTM(E, H).cuda()
    with torch.no_grad():
        for dst, src in zip((ref.weight_ih_l0, ref.bias_ih_l0,
                             ref.weight_hh_l0, ref.bias_hh_l0), w):
            dst.copy_(src)
    g = torch.Generator(device="cuda").manual_seed(17)
    inp = torch.randn(T, B, E, generator=g, device="cuda",
                      requires_grad=True)
    cot = torch.randn(T, B, H, generator=g, device="cuda")
    h0 = torch.zeros(B, H, device="cuda")
    wq = [t.clone().requires_grad_(True) for t in w]

    def ours():
        out, _, _ = ops_rnn._scan(inp, h0, h0, *wq, "lstm", False)
        return torch.autograd.grad(out, [inp] + wq, cot), out

    def cudnn():
        out, _ = ref(inp, (h0[None], h0[None]))
        return torch.autograd.grad(out, [inp] + list(ref.parameters()),
                                   cot), out

    (g_ours, o_ours), (g_ref, o_ref) = ours(), cudnn()
    err = (o_ours - o_ref).abs().max().item()
    gerr = (g_ours[0] - g_ref[0]).abs().max().item()
    # free the graphs: a live one keeps its leaves' gradient nodes on the
    # default stream, which a capture may not join
    del g_ours, o_ours, g_ref, o_ref
    check(err < 1e-4 and gerr < 1e-4,
          f"rnn (a) yardstick: rnn_scan and torch.nn.LSTM disagree: outputs "
          f"{err:.3e}, input gradients {gerr:.3e}")
    eager_ms = timed_ms(torch, ours, 10)
    prog = GraphProgram(ours)     # the backward runs on autograd's thread
    prog.capture(warm_up=ours)
    graph = timed_ms(torch, prog.replay, 10)
    cudnn_ms = timed_ms(torch, cudnn, 10)
    print(f"rnn (a) yardstick [{smi}]: one LSTM layer T{T} B{B} {E} -> {H} "
          f"f32, forward + backward: rnn_scan eager {eager_ms:.3f} ms, "
          f"captured {graph:.3f} ms; torch.nn.LSTM (cuDNN) {cudnn_ms:.3f} ms "
          f"eager; outputs agree to {err:.2e}, input gradients to "
          f"{gerr:.2e}", flush=True)
    return dict(layer_eager_ms=eager_ms, layer_graph_ms=graph,
                cudnn_ms=cudnn_ms)


def rel_err(torch, a, b):
    """max |a - b| over max(max |b|, 1)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)


def share_err(torch, a, b):
    """max |a - b| over max |b| (each tensor's largest entry)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def packed_size(gates, layers, I, H, dirs):
    """The fused RNN op's parameter vector length."""
    n = 0
    for layer in range(layers):
        isz = I if layer == 0 else dirs * H
        n += dirs * (gates * H * isz + gates * H * H + 2 * gates * H)
    return n


def rnn_card_vs_cpu(torch, mx, gluon, parallel, optimizer, loss_mod):
    """(b) a small LSTM LM, and the fused RNN op, on the card and the
    CPU from the same weights and inputs."""
    import numpy as np
    from mxtpu_torch import nd
    c = dict(vocab=50, embed=64, hidden=64, layers=2)
    T, B = 8, 4
    rs = np.random.RandomState(3)
    xv = rs.randint(0, c["vocab"], (B, T)).astype(np.int32)
    yv = rs.randint(0, c["vocab"], (T * B,)).astype(np.float32)
    nets, res = {}, {}
    for dev, ctx in (("cpu", mx.cpu()), ("cuda", mx.gpu(0))):
        nets[dev] = word_lm_net(gluon, c)
        nets[dev].initialize(mx.init.Xavier(), ctx=ctx)
    for p, q in zip(nets["cpu"].collect_params().values(),
                    nets["cuda"].collect_params().values()):
        q.set_data(p.data().as_in_context(mx.gpu(0)))
    for dev, net in nets.items():
        x, y = torch.from_numpy(xv).to(dev), torch.from_numpy(yv).to(dev)
        net.eval()
        with torch.no_grad():
            logits = net(x)
        dpt = parallel.DataParallelTrainer(
            net, loss_mod.SoftmaxCrossEntropyLoss(),
            optimizer.SGD(learning_rate=0.1, momentum=0.9), device=dev)
        loss = float(dpt.step_async(x, y))
        res[dev] = (logits, loss, [p._tensor().detach().clone()
                                   for p in net.collect_params().values()])
    lerr = rel_err(torch, res["cuda"][0], res["cpu"][0])
    werr = max(share_err(torch, a, b)
               for a, b in zip(res["cuda"][2], res["cpu"][2]))
    loss_err = abs(res["cuda"][1] - res["cpu"][1]) / max(abs(res["cpu"][1]),
                                                         1.0)
    check(lerr <= RNN_FWD_TOL and loss_err <= RNN_FWD_TOL
          and werr <= RNN_STEP_TOL,
          f"rnn (b) LSTM LM card vs CPU: logits {lerr:.3e} (tol "
          f"{RNN_FWD_TOL:g}), loss {loss_err:.3e}, weights after one SGD "
          f"step {werr:.3e} of each tensor's largest entry (tol "
          f"{RNN_STEP_TOL:g})")
    out = [f"LSTM LM (2 x 64, T{T} B{B}) logits {lerr:.3e}, loss "
           f"{loss_err:.3e}, weights after one SGD-momentum step {werr:.3e}"]
    cases = [("gru, 2 layers, bidirectional", "gru", 3, 2, True),
             ("rnn_tanh, 1 layer", "rnn_tanh", 1, 1, False)]
    I, H, T2, B2 = 16, 32, 10, 4
    for label, mode, gates, layers, bi in cases:
        dirs = 2 if bi else 1
        vals = [rs.randn(T2, B2, I).astype(np.float32),
                rs.uniform(-0.3, 0.3, packed_size(gates, layers, I, H, dirs))
                .astype(np.float32),
                rs.randn(layers * dirs, B2, H).astype(np.float32)]
        got = {}
        for dev, ctx in (("cpu", mx.cpu()), ("cuda", mx.gpu(0))):
            outs = nd.RNN(*[nd.array(v, ctx=ctx) for v in vals],
                          state_size=H, num_layers=layers, mode=mode,
                          bidirectional=bi, state_outputs=True)
            got[dev] = [o.data for o in outs]
        errs = [rel_err(torch, a, b) for a, b in zip(got["cuda"],
                                                      got["cpu"])]
        check(max(errs) <= RNN_FWD_TOL,
              f"rnn (b) fused RNN op {label}: card vs CPU output and states "
              f"{errs} (tol {RNN_FWD_TOL:g})")
        out.append(f"nd.RNN {label} (T{T2} B{B2} {I} -> {H}) output and "
                   f"states {max(errs):.3e}")
    print("rnn (b) card vs CPU, each as a share of max(|CPU|, 1): "
          + "; ".join(out), flush=True)


def bptt_flow(torch, mx, gluon, nd, autograd, jit, step_cache):
    """(c) ``examples/train_word_lm.py``'s flow: a ``CachedOp`` over the
    window loss (eager under ``record``, captured in predict mode),
    states detached between windows, ``clip_global_norm`` and
    ``gluon.Trainer`` SGD; returns the best validation perplexity."""
    import numpy as np
    c = BPTT
    mx.random.seed(0)
    corpus = make_corpus(c["vocab"], c["corpus_len"], c["branch"])
    split = int(0.9 * len(corpus))
    train_data = batchify(corpus[:split], c["batch"])
    valid_data = batchify(corpus[split:], c["batch"])
    embedding = gluon.nn.Embedding(c["vocab"], c["embed"])
    lstm = gluon.rnn.LSTM(c["hidden"], num_layers=c["layers"], layout="TNC",
                          input_size=c["embed"])
    decoder = gluon.nn.Dense(c["vocab"], in_units=c["hidden"], flatten=False)
    params = {}
    for b in (embedding, lstm, decoder):
        b.initialize(mx.init.Xavier())
        params.update(b.collect_params()._params)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": c["lr"]})

    def window_loss(x, y, h, cc):
        out, (h2, c2) = lstm(embedding(x), [h, cc])
        logits = decoder(out)
        loss = loss_fn(logits.reshape((-1, c["vocab"])), y.reshape((-1,)))
        return nd.mean(loss), h2, c2

    step = jit.CachedOp(window_loss,
                        params=[p.data() for p in params.values()])
    step_cache.reset_stats("cached_op")

    evals = [0]

    def run_epoch(data, train):
        total, windows = 0.0, 0
        h, cc = lstm.begin_state(c["batch"])
        for start in range(0, data.shape[1] - 1 - c["bptt"], c["bptt"]):
            x = nd.array(data[:, start:start + c["bptt"]].T.astype(np.int32))
            y = nd.array(data[:, start + 1:start + 1 + c["bptt"]].T
                         .astype(np.int32))
            h, cc = h.detach(), cc.detach()
            if train:
                with autograd.record():
                    loss, h, cc = step(x, y, h, cc)
                loss.backward()
                gluon.utils.clip_global_norm(
                    [p.grad() for p in params.values()], c["clip"])
                trainer.step(1)
            else:
                with autograd.predict_mode():
                    loss, h, cc = step(x, y, h, cc)
                evals[0] += 1
            total += float(loss.asscalar())
            windows += 1
        return float(np.exp(total / max(windows, 1)))

    best, ppls = float("inf"), []
    t0 = time.monotonic()
    for _ in range(c["epochs"]):
        train_ppl = run_epoch(train_data, True)
        valid_ppl = run_epoch(valid_data, False)
        if valid_ppl >= best:
            trainer.set_learning_rate(trainer.learning_rate / 4.0)
        best = min(best, valid_ppl)
        ppls.append((round(train_ppl, 2), round(valid_ppl, 2)))
    secs = time.monotonic() - t0
    stats, cache = step.stats(), step_cache.snapshot()["cached_op"]
    check(best < c["ppl_gate"] and stats["captured"] == 1
          and stats["replays"] == evals[0] - 1
          and cache["traces"] == 2 and cache["hits"] > 0,
          f"rnn (c) BPTT: best valid perplexity {best:.2f} (gate < "
          f"{c['ppl_gate']:g}); (train, valid) a epoch {ppls}; CachedOp "
          f"programs {stats}, cached_op {cache}")
    print(f"rnn (c) examples/train_word_lm.py flow (vocab {c['vocab']}, "
          f"embed/hidden {c['hidden']}, B{c['batch']}, bptt {c['bptt']}, lr "
          f"{c['lr']:g}, clip {c['clip']}, {c['epochs']} epochs, "
          f"{secs:.1f} s): (train, valid) perplexity a epoch {ppls}, best "
          f"{best:.2f} (gate < {c['ppl_gate']:g}, uniform {c['vocab']}, "
          f"chain {c['branch']}); CachedOp: training windows eager under "
          f"record, validation captured once and replayed {stats}; "
          f"cached_op {cache}", flush=True)
    return best


def control_flow_on_card(torch, mx, gluon, nd, autograd, jit):
    """(d) foreach against rnn_scan, while_loop card vs CPU, and cond
    inside a captured CachedOp."""
    import numpy as np
    gpu = mx.gpu(0)
    rs = np.random.RandomState(8)
    cell = gluon.rnn.LSTMCell(64, input_size=32)
    cell.initialize(mx.init.Xavier(), ctx=gpu)
    x = nd.array(rs.randn(10, 8, 32).astype(np.float32), ctx=gpu)
    h0 = nd.array(rs.randn(8, 64).astype(np.float32), ctx=gpu)
    c0 = nd.array(rs.randn(8, 64).astype(np.float32), ctx=gpu)
    outs, (hT, cT) = nd.contrib.foreach(lambda xt, st: cell(xt, st), x,
                                        [h0, c0])
    p = cell.collect_params()
    w = [p[cell.prefix + k].data() for k in ("i2h_weight", "i2h_bias",
                                              "h2h_weight", "h2h_bias")]
    ref = nd.rnn_scan(x, h0, c0, *w, mode="lstm")
    fe = max((a.data - b.data).abs().max().item()
             for a, b in zip((outs, hT, cT), ref))
    check(fe <= FOREACH_TOL, f"rnn (d) foreach over an LSTMCell against "
          f"rnn_scan: {fe:.3e} (tol {FOREACH_TOL:g})")

    def while_example(ctx):
        with mx.Context(ctx):
            outputs, states = nd.contrib.while_loop(
                lambda i, s: i <= 5, lambda i, s: ([i + s], [i + 1, s + i]),
                (nd.array([0.0]), nd.array([1.0])), max_iterations=10)
            v = nd.array([2.0])
            v.attach_grad()
            with autograd.record():
                _, st = nd.contrib.while_loop(
                    lambda a: nd.sum(a) < 100.0, lambda a: ([a * a], [a * a]),
                    [v], max_iterations=8)
                loss = nd.sum(st[0])
            loss.backward()
            return [outputs[0].asnumpy()] + [s.asnumpy() for s in states] \
                + [st[0].asnumpy(), v.grad.asnumpy()]

    card, host = while_example(gpu), while_example(mx.cpu())
    we = max(float(np.abs(a - b).max()) for a, b in zip(card, host))
    check(we == 0.0 and card[-1][0] == 8 * 2.0 ** 7,
          f"rnn (d) while_loop card vs CPU: {card} vs {host}")

    op = jit.CachedOp(lambda a: nd.contrib.cond(
        lambda: nd.sum(a) > 0, lambda: a * 2.0, lambda: a * 5.0))
    vals = [rs.randn(16).astype(np.float32) for _ in range(6)]
    for i, v in enumerate(vals):
        v[:] = np.abs(v) * (1 if i % 2 else -1)
    got = [op(nd.array(v, ctx=gpu)).asnumpy() for v in vals]
    want = [v * (2.0 if v.sum() > 0 else 5.0) for v in vals]
    st = op.stats()
    diffs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
    check(not any(diffs) and st["captured"] == 1
          and st["replays"] == len(vals) - 1,
          f"rnn (d) cond in a captured CachedOp: {st}; results vs the "
          f"eager branch {diffs}")
    print(f"rnn (d) control flow on the card: foreach over an LSTMCell "
          f"(T10 B8 32 -> 64) against rnn_scan {fe:.3e} (tol "
          f"{FOREACH_TOL:g}); while_loop's reference example and its "
          f"gradient (8 x 2^7) card vs CPU {we:.1e}; cond inside a CachedOp "
          f"captured once {st}: both predicates equal the eager branch",
          flush=True)


def bucket_sentences(rs, n, vocab, min_len=3, max_len=12):
    """``tests/test_bucketing.py``'s sentences: successor = (2 tok + 1) %
    (vocab - 1) + 1 (0 is the pad)."""
    out = []
    for _ in range(n):
        L = rs.randint(min_len, max_len + 1)
        s = [int(rs.randint(1, vocab))]
        for _ in range(L - 1):
            s.append((2 * s[-1] + 1) % (vocab - 1) + 1)
        out.append(s)
    return out


def bucketing_on_card(torch, mx, gluon):
    """(e) BucketSentenceIter into BucketingModule over an NTC LSTM: one
    epoch, one fused program a bucket, and the masked cross-entropy over
    the epoch's batches falls."""
    import numpy as np
    vocab = 20
    it = mx.rnn.BucketSentenceIter(
        bucket_sentences(np.random.RandomState(1), 96, vocab), batch_size=8,
        buckets=[4, 8, 12], invalid_label=0)

    class TinyLM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.emb = gluon.nn.Embedding(vocab, 16)
                self.lstm = gluon.rnn.LSTM(32, input_size=16, layout="NTC")
                self.out = gluon.nn.Dense(vocab, flatten=False, in_units=32)

        def forward(self, x):
            return self.out(self.lstm(self.emb(x)))

    net = TinyLM()
    bm = mx.mod.BucketingModule(
        lambda key: (net, ("data",), ("softmax_label",)),
        default_bucket_key=it.default_bucket_key,
        loss=gluon.loss.SoftmaxCrossEntropyLoss(ignore_label=0))
    bm.bind(it.provide_data, it.provide_label)
    bm.init_params(initializer=mx.init.Xavier())
    bm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 0.02})

    def epoch_ce():
        tot, ntok = 0.0, 0
        it.reset()
        for batch in it:
            bm.forward(batch, is_train=False)
            p = bm.get_outputs()[0].asnumpy()
            y = batch.label[0].asnumpy().astype(int)
            mask = y > 0
            tot += -np.log(np.maximum(np.take_along_axis(
                p, y[..., None], -1)[..., 0], 1e-9))[mask].sum()
            ntok += int(mask.sum())
        return tot / ntok

    before = epoch_ce()
    it.reset()
    keys = []
    for batch in it:
        bm.forward_backward(batch)
        bm.update()
        keys.append(batch.bucket_key)
    after = epoch_ce()
    stats = {k: m._step_exec.stats() for k, m in bm._modules.items()
             if m._step_exec is not None}
    check(after < before and sorted(stats) == [4, 8, 12]
          and all(s["programs"] == 1 for s in stats.values()),
          f"rnn (e) bucketing: masked cross-entropy {before:.4f} -> "
          f"{after:.4f} over one epoch; programs a bucket {stats}")
    print(f"rnn (e) BucketSentenceIter (buckets 4, 8, 12, B8) into "
          f"BucketingModule over an NTC LSTM, one epoch of {len(keys)} "
          f"batches: masked cross-entropy {before:.4f} -> {after:.4f}; one "
          f"fused program a bucket {stats}", flush=True)


def phase_rnn(torch, mx, counts, smi):
    """Phase 17: recurrent nets, control flow and jit on the card (see the
    module docstring). Returns (a)'s readings."""
    from mxtpu_torch import (autograd, gluon, jit, nd, optimizer, parallel,
                             step_cache)
    from mxtpu_torch.gluon import loss as loss_mod
    from mxtpu_torch.ops import attention, quant_attention
    counts(0)
    out = word_lm_train(torch, mx, gluon, parallel, optimizer, loss_mod, smi)
    rnn_card_vs_cpu(torch, mx, gluon, parallel, optimizer, loss_mod)
    out["ppl"] = bptt_flow(torch, mx, gluon, nd, autograd, jit, step_cache)
    control_flow_on_card(torch, mx, gluon, nd, autograd, jit)
    bucketing_on_card(torch, mx, gluon)
    launches = dict(attention_launches(attention),
                    K5=quant_attention.dequant_decode.launches)
    check(not any(launches.values()),
          f"phase 17 launched a TPU kernel's port: {launches} (the RNN path "
          f"runs none of K1-K5)")
    print(f"rnn: no TPU kernel lies on this path: K1-K5 launches "
          f"{launches}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: the data path
# ---------------------------------------------------------------------------

# bench.py's bench_train_e2e: 384 records of 224x224 noise JPEGs, B128,
# 4 epochs (3 batches each: 1 warm step and 11 timed), bf16
DATA_E2E = dict(n_img=384, hw=224, batch=128, epochs=4, syn_steps=11)
# the e2e leg's on-card normalize (bench.py:828-829)
E2E_MEAN, E2E_STD = (123.68, 116.78, 103.94), (58.4, 57.12, 57.38)
# (c): ImageNet's mean and std of [0, 1] pixels
GLUON_MEAN, GLUON_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
FIXTURE = os.path.join("mxtpu_torch", "fixtures", "jpeg224")
# (b): nd.image card against CPU, as tests/test_torch_image.py holds the
# port to the JAX package: 1e-5 rel + 1e-6 abs; resize's float output
# 1e-5 rel + 1e-4 abs on [0, 255] images, its uint8 output within one step
IMAGE_RTOL, IMAGE_ATOL, RESIZE_ATOL = 1e-5, 1e-6, 1e-4


def fixture_records(tmp):
    """The committed fixture (``make_jpeg224.py``): its 16 JPEGs, checked
    against their SHA-256, packed as ``DATA_E2E["n_img"]`` records (image
    i % 16, label i % 10) by the port's pure-Python ``recordio``.
    Returns the ``.rec`` path, the fixture's JSON and the JPEG bytes."""
    import hashlib
    from mxtpu_torch import recordio
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE)
    with open(os.path.join(root, "decoded.json")) as f:
        meta = json.load(f)
    jpegs = []
    for im in meta["images"]:
        with open(os.path.join(root, im["file"]), "rb") as f:
            jpegs.append(f.read())
        check(hashlib.sha256(jpegs[-1]).hexdigest() == im["sha256_file"],
              f"fixture {im['file']} differs from its JSON")
    path = os.path.join(tmp, "e2e.rec")
    with recordio.MXRecordIO(path, "w") as w:
        for i in range(DATA_E2E["n_img"]):
            w.write(recordio.pack(recordio.IRHeader(0, float(i % 10), i, 0),
                                  jpegs[i % len(jpegs)]))
    return path, meta, jpegs


def e2e_iter(mx, rec, nproc, ctx, shuffle=False, threads=None):
    """``bench_train_e2e``'s iterator: uint8 NCHW batches with random
    mirrors, ``nproc`` decode threads, two batches prefetched; with
    ``ctx`` a ``DeviceFeed`` staging them there."""
    hw = DATA_E2E["hw"]
    return mx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, hw, hw),
        batch_size=DATA_E2E["batch"], rand_mirror=True, shuffle=shuffle,
        dtype="uint8", preprocess_threads=threads or nproc,
        prefetch_buffer=2, ctx=ctx)


def data_train_e2e(torch, mx, rec, nproc):
    """(a) ``bench_train_e2e`` on the card: ResNet-50 v1 bf16 B128 (phase
    15's trainer) fed from RecordIO through ``ImageRecordIter`` (uint8 on
    the wire, normalized on the card), against the same trainer on a
    resident batch, the iterator alone and the iterator with the
    transfer."""
    from mxtpu_torch import image, optimizer, parallel
    from mxtpu_torch.gluon import loss as loss_mod
    from mxtpu_torch.gluon.model_zoo import vision
    B, epochs, syn_steps = DATA_E2E["batch"], DATA_E2E["epochs"], \
        DATA_E2E["syn_steps"]
    mean = torch.tensor(E2E_MEAN, device="cuda").view(1, 3, 1, 1)
    std = torch.tensor(E2E_STD, device="cuda").view(1, 3, 1, 1)

    def batches():
        it = e2e_iter(mx, rec, nproc, mx.gpu(0))
        try:
            for _ in range(epochs):
                it.reset()
                for b in it:
                    if b.pad:
                        continue            # steady-state batches only
                    x = ((b.data[0].data.float() - mean) / std).to(
                        torch.bfloat16)
                    yield x, b.label[0].data
        finally:
            it.close()

    net, dpt = resnet50_trainer(mx, vision, parallel, optimizer, loss_mod,
                                "bfloat16", 1)
    # the compute floor: the same trainer and program on a resident batch
    xs, ys = vision_batch(torch, B, "bfloat16")
    float(dpt.step_async(xs, ys))           # shapes, body
    float(dpt.step_async(xs, ys))           # capture, replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(syn_steps):
        loss = dpt.step_async(xs, ys)
    float(loss)
    syn_ms = (time.perf_counter() - t0) / syn_steps * 1e3
    before = dpt.stats()

    gen = batches()
    x0, y0 = next(gen)
    warm_loss = float(dpt.step_async(x0, y0))
    steps, losses = 0, []
    t0 = time.perf_counter()
    for x, y in gen:
        losses.append(dpt.step_async(x, y))   # async: decode overlaps
        steps += 1
    losses = [float(v) for v in losses]
    wall = time.perf_counter() - t0
    after = dpt.stats()
    check(steps == epochs * (DATA_E2E["n_img"] // B) - 1,
          f"(a) e2e: {steps} timed steps")
    check(all(math.isfinite(v) for v in [warm_loss] + losses),
          f"(a) e2e losses {[warm_loss] + losses}")
    check(after["captured"] == 1 and before["captured"] == 1
          and after["replays"] - before["replays"] == steps + 1,
          f"(a) e2e: trainer {before} -> {after}: want one capture and "
          f"{steps + 1} replays")
    del net, dpt

    # the iterator alone: host uint8 slabs
    t0 = time.perf_counter()
    feed_steps = 0
    it = e2e_iter(mx, rec, nproc, None)
    for _ in range(epochs):
        it.reset()
        for b in it:
            if b.pad:
                continue
            check(b.data[0].data.dtype == torch.uint8,
                  f"(a) host feed: {b.data[0].data.dtype} slab")
            feed_steps += 1
    feed_wall = time.perf_counter() - t0
    # the iterator through the device boundary, normalized on the card
    t0 = time.perf_counter()
    ft_steps = 0
    for x, _ in batches():
        ft_steps += 1
    torch.cuda.synchronize()
    ft_wall = time.perf_counter() - t0

    out = dict(img_s=steps * B / wall, steps=steps, wall_s=wall,
               cpu_count=nproc, route=image.DECODE_ROUTE,
               host_feed_img_s=feed_steps * B / feed_wall,
               feed_transfer_img_s=ft_steps * B / ft_wall,
               synthetic_ms=syn_ms, synthetic_img_s=B * 1e3 / syn_ms)
    out["overlap_efficiency"] = out["img_s"] / out["feed_transfer_img_s"]
    out["chip_idle"] = max(0.0, 1 - steps * syn_ms / 1e3 / wall)
    pace = ("the host sets the pace" if out["host_feed_img_s"]
            < 1.5 * out["synthetic_img_s"] else "the card sets the pace")
    print(f"data (a) e2e: ResNet-50 v1 bf16 B{B} SGD(0.05, momentum 0.9, "
          f"wd 1e-4), captured once, fed by ImageRecordIter(uint8, "
          f"rand_mirror, preprocess_threads={nproc}, prefetch_buffer=2, "
          f"ctx=gpu(0)) over {DATA_E2E['n_img']} records, normalized on the "
          f"card; decode route {image.DECODE_ROUTE}; nproc {nproc}: "
          f"{steps} timed steps {out['img_s']:.1f} img/s end to end (wall "
          f"{wall:.3f} s; loss {warm_loss:.4f} -> {losses[-1]:.4f}); "
          f"synthetic (resident batch, same program) {syn_ms:.3f} ms a "
          f"step = {out['synthetic_img_s']:.1f} img/s; host feed "
          f"{out['host_feed_img_s']:.1f} img/s; feed+transfer "
          f"{out['feed_transfer_img_s']:.1f} img/s; overlap efficiency "
          f"{out['overlap_efficiency']:.3f}; chip idle {out['chip_idle']:.3f}"
          f"; {pace} (host feed / synthetic "
          f"{out['host_feed_img_s'] / out['synthetic_img_s']:.2f})",
          flush=True)
    return out


def data_card_vs_cpu(torch, mx, rec, meta, jpegs, nproc):
    """(b) the decode route against the fixture's JSON; one epoch of
    ``ImageRecordIter`` staged to the card against the host path with one
    thread, seeded alike; every ``nd.image`` op card against CPU."""
    import hashlib
    import random as pyrandom
    import numpy as np
    from mxtpu_torch import image, nd
    from mxtpu_torch.ndarray.ndarray import NDArray
    route = image.DECODE_ROUTE
    check(route in ("libjpeg", "pillow"), f"(b) decode route {route}")
    rs = np.random.RandomState(meta["seed"])
    hw = meta["shape"][0]
    maes = []
    for im, buf in zip(meta["images"], jpegs):
        src = rs.randint(0, 255, (hw, hw, 3)).astype(np.uint8)
        dec = image.imdecode(buf).asnumpy()
        check(hashlib.sha256(dec.tobytes()).hexdigest()
              == im["sha256_decoded"],
              f"(b) {im['file']} decodes on the {route} route to other "
              f"bytes than the fixture's libjpeg decode")
        maes.append(float(np.abs(dec.astype(np.int16) - src).mean()))
        check(maes[-1] == im["mae_vs_source"], f"(b) {im['file']} MAE")
    from mxtpu_torch import native
    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = "absent"
    print(f"data (b) decode route {route} (jpeglib.h: "
          f"{native.jpeg_header()}; Pillow {pillow}; native "
          f"library built: {native.available()}): the {len(jpegs)} fixture "
          f"JPEGs decode to the SHA-256 of the fixture's libjpeg decode; MAE "
          f"against the seeded source {min(maes):.4f}-{max(maes):.4f}",
          flush=True)

    def epoch(ctx, threads):
        pyrandom.seed(18)
        it = e2e_iter(mx, rec, nproc, ctx, shuffle=True, threads=threads)
        try:
            return [(b.data[0].data.cpu(), b.label[0].data.cpu(), b.pad)
                    for b in it]
        finally:
            if ctx is not None:
                it.close()

    card = epoch(mx.gpu(0), nproc)
    host = epoch(None, 1)
    check(len(card) == len(host) == DATA_E2E["n_img"] // DATA_E2E["batch"]
          and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                  and a[2] == b[2] for a, b in zip(card, host)),
          "(b) ImageRecordIter staged to the card differs from the host "
          "path with one thread")
    print(f"data (b) one shuffled, mirrored epoch ({len(card)} batches) "
          f"staged to the card through ImageRecordIter(ctx=gpu(0), "
          f"{nproc} threads) bit-equal to the host path with 1 thread, "
          f"seeded alike", flush=True)

    g = np.random.RandomState(18)
    u8 = g.randint(0, 255, (2, 37, 53, 3)).astype(np.uint8)
    f32 = (g.rand(2, 37, 53, 3) * 255).astype(np.float32)
    chw = g.rand(2, 3, 37, 53).astype(np.float32)
    cases = [("to_tensor", u8, {}), ("to_tensor", u8[0], {}),
             ("normalize", chw, dict(mean=(0.1, 0.2, 0.3),
                                     std=(0.5, 0.25, 2.0))),
             ("flip_left_right", f32, {}), ("flip_top_bottom", f32[0], {}),
             ("crop", u8, dict(x=3, y=5, width=20, height=17)),
             ("random_flip_left_right", u8, dict(p=1.0)),
             ("random_flip_top_bottom", u8, dict(p=0.0)),
             ("resize", f32, dict(size=(20, 14))),
             ("resize", f32[0], dict(size=100)),
             ("resize", u8, dict(size=16, keep_ratio=True)),
             ("resize", u8[0], dict(size=(70, 50), interp=0))]
    worst = 0.0
    for name, x, kw in cases:
        op = getattr(nd.image, name)
        a = op(NDArray(torch.from_numpy(x).cuda()), **kw).asnumpy()
        b = op(NDArray(torch.from_numpy(x)), **kw).asnumpy()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"(b) nd.image.{name}: {a.shape} {a.dtype} vs {b.shape} "
              f"{b.dtype}")
        if a.dtype == np.uint8:
            d = int(np.abs(a.astype(np.int16) - b).max())
            check(d <= (1 if name == "resize" else 0),
                  f"(b) nd.image.{name} {kw}: uint8 outputs {d} apart")
            continue
        atol = RESIZE_ATOL if name == "resize" else IMAGE_ATOL
        err = np.abs(a - b) - IMAGE_RTOL * np.abs(b)
        check(float(err.max()) <= atol,
              f"(b) nd.image.{name} {kw}: card vs CPU beyond "
              f"{IMAGE_RTOL:g} rel + {atol:g} abs")
        worst = max(worst, float((np.abs(a - b) / (np.abs(b) + 1)).max()))
    flips = [bool(torch.equal(nd.image.random_flip_left_right(
        NDArray(torch.from_numpy(u8[0]).cuda())).data.cpu(),
        torch.from_numpy(u8[0][:, ::-1].copy()))) for _ in range(64)]
    check(0 < sum(flips) < 64, f"(b) random_flip_left_right(p=0.5) on the "
          f"card flipped {sum(flips)} of 64")
    print(f"data (b) nd.image: {len(cases)} cases of the 8 ops card vs CPU "
          f"within {IMAGE_RTOL:g} rel + {IMAGE_ATOL:g} abs (resize "
          f"{RESIZE_ATOL:g} abs, uint8 one step); largest |card - CPU| / "
          f"(|CPU| + 1) {worst:.3e}; random_flip_left_right(p=0.5) flipped "
          f"{sum(flips)} of 64 on the card", flush=True)


def data_gluon_flow(torch, mx, rec, nproc):
    """(c) ``ImageRecordDataset`` through the Gluon transforms and
    ``DataLoader(num_workers=nproc, ctx=gpu(0))``, scoring f32 ResNet-50
    at B32; one batch's logits against the same batch fed from a resident
    tensor."""
    from mxtpu_torch import autograd, profiler
    from mxtpu_torch.gluon.data import DataLoader
    from mxtpu_torch.gluon.data.vision import ImageRecordDataset, transforms
    from mxtpu_torch.gluon.model_zoo import vision
    from mxtpu_torch.ndarray.ndarray import NDArray
    B = 32
    tr = transforms.Compose([transforms.RandomFlipLeftRight(),
                             transforms.ToTensor(),
                             transforms.Normalize(GLUON_MEAN, GLUON_STD)])
    ds = ImageRecordDataset(rec).transform_first(tr)
    loader = DataLoader(ds, batch_size=B, num_workers=nproc, ctx=mx.gpu(0),
                        last_batch="discard")
    mx.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize()
    g = torch.Generator(device="cuda").manual_seed(1)
    with autograd.predict_mode():
        net(NDArray(torch.rand((B, 3, 224, 224), generator=g,
                               device="cuda")))
    torch.cuda.synchronize()
    profiler.reset_feed_stats()
    n, first = 0, None
    t0 = time.perf_counter()
    with autograd.predict_mode():
        for x, _ in loader:
            out = net(x)
            if first is None:
                first = (x.data, out.data)
            n += x.shape[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = profiler.get_feed_stats()
    check(n == len(loader) * B == DATA_E2E["n_img"],
          f"(c) scored {n} images")
    resident = first[0].cpu().to("cuda")
    with autograd.predict_mode():
        again = net(NDArray(resident)).data
    check(tuple(first[1].shape) == (B, 1000)
          and bool(torch.isfinite(first[1]).all())
          and torch.equal(first[1], again),
          "(c) the first batch's logits differ from the same batch fed "
          "from a resident tensor")
    stall = stats["stall_ms_total"] / (wall * 1e3)
    print(f"data (c) Gluon: ImageRecordDataset -> Compose([RandomFlip"
          f"LeftRight, ToTensor, Normalize]) -> DataLoader(num_workers="
          f"{nproc}, ctx=gpu(0)) scoring ResNet-50 v1 f32 B{B}: {n} images "
          f"{n / wall:.1f} img/s (wall {wall:.3f} s); feed stall "
          f"{stats['stall_ms_total']:.1f} ms = {stall:.3f} of the wall over "
          f"{stats['batches_consumed']} batches, {stats['transfer_bytes']} "
          f"bytes staged; the first batch's logits bit-equal to the same "
          f"batch fed from a resident tensor", flush=True)
    return dict(img_s=n / wall, stall=stall)


def data_mnist_fit(mx):
    """(d) ``examples/train_mnist.py``'s flow with ``--network lenet``:
    ``MNISTIter`` (the synthetic source) into ``Module.fit`` on the card,
    3 epochs at B64, SGD(0.05, momentum 0.9); held-out accuracy > 0.9 (the
    gate of ``tests/test_examples.py:70-75``)."""
    from mxtpu_torch.gluon.model_zoo import vision
    train = mx.io.MNISTIter(batch_size=64, flat=False)
    val = mx.io.MNISTIter(batch_size=64, flat=False, seed=7)
    mx.random.seed(0)
    mod = mx.mod.Module(vision.lenet(classes=10), context=mx.gpu(0))
    t0 = time.monotonic()
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            num_epoch=3)
    fit_s = time.monotonic() - t0
    acc = dict(mod.score(val, "acc"))["accuracy"]
    check(acc > 0.9, f"(d) LeNet on MNISTIter: accuracy {acc:.4f} (gate "
          f"> 0.9)")
    print(f"data (d) MNISTIter (synthetic) -> Module.fit(LeNet) on the card, "
          f"3 epochs B64: {fit_s:.2f} s, held-out accuracy {acc:.4f} (gate "
          f"> 0.9)", flush=True)


def phase_data(torch, mx, counts, smi):
    """Phase 18: the data path on the card (see the module docstring).
    Returns (a)'s readings."""
    import tempfile
    from mxtpu_torch.ops import attention, quant_attention
    nproc = os.cpu_count() or 1
    counts(0)
    with tempfile.TemporaryDirectory() as tmp:
        rec, meta, jpegs = fixture_records(tmp)
        out = data_train_e2e(torch, mx, rec, nproc)
        torch.cuda.empty_cache()
        data_card_vs_cpu(torch, mx, rec, meta, jpegs, nproc)
        out["gluon"] = data_gluon_flow(torch, mx, rec, nproc)
        torch.cuda.empty_cache()
    data_mnist_fit(mx)
    launches = dict(attention_launches(attention),
                    K5=quant_attention.dequant_decode.launches)
    check(not any(launches.values()),
          f"phase 18 launched a TPU kernel's port: {launches} (the data "
          f"path runs none of K1-K5)")
    print(f"data: no TPU kernel lies on this path: K1-K5 launches "
          f"{launches} ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: detection
# ---------------------------------------------------------------------------

# examples/train_ssd_toy.py's defaults
SSD_TOY = dict(classes=3, sizes=(0.35, 0.6), ratios=(1.0, 2.0), steps=150,
               batch=16, lr=0.4, momentum=0.9, eval_n=32, eval_iou=0.4,
               iou_bar=0.3, cpu_steps=3, loss_rel=1e-5)
# tests/test_examples.py's configuration of examples/train_rcnn_toy.py
RCNN_TOY = dict(batch=8, steps=150, lr=0.05, size=64, stride=8,
                scales=(2.0, 4.0), ratios=(1.0,), post=8, rpn_acc=0.75,
                roi_acc=0.5, pos_frac=0.25, tail=10)
DET_REC = dict(n=64, batch=16, size=64, seed=5)
# SSD300's detection layer (VGG16-reduced, MXNet's example/ssd)
SSD300 = dict(maps=(38, 19, 10, 5, 3, 1),
              channels=(512, 1024, 512, 256, 256, 256),
              sizes=((0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
                     (0.54, 0.619), (0.71, 0.79), (0.88, 0.961)),
              ratios=((1, 2, 0.5), (1, 2, 0.5, 3, 1 / 3),
                      (1, 2, 0.5, 3, 1 / 3), (1, 2, 0.5, 3, 1 / 3),
                      (1, 2, 0.5), (1, 2, 0.5)),
              classes=21, batch=32, gts=50, nms=0.45, nms_topk=400,
              anchors=8732)
# Faster R-CNN's RPN and pooling (VGG16, stride 16, a 600 x 1000 image)
FRCNN = dict(batch=2, h=38, w=63, channels=512, scales=(8, 16, 32),
             ratios=(0.5, 1, 2), stride=16, im=(600, 1000), pre=6000,
             post=300, thr=0.7, pooled=(7, 7), anchors=21546,
             roi_bytes=2 << 30)
DET_RTOL, DET_ATOL = 1e-5, 1e-6      # (e)'s tolerances, as the CPU tests'
DET_KEEP_TOL = 1e-5                  # a differing keep: |IoU - thr| bound


def ssd_toy_net(gluon, num_classes=3, num_anchors=3):
    """examples/train_ssd_toy.py's net: three stride-2 3x3 convs and the
    class and box heads, in the Gluon package ``gluon``."""
    nn = gluon.nn

    class ToySSD(nn.HybridSequential):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                for ch in (16, 32, 64):
                    self.backbone.add(nn.Conv2D(ch, 3, strides=2, padding=1,
                                                activation="relu"))
                self.cls_head = nn.Conv2D(num_anchors * (num_classes + 1), 3,
                                          padding=1)
                self.loc_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

        def forward(self, x):
            feat = self.backbone(x)
            return feat, self.cls_head(feat), self.loc_head(feat)

    return ToySSD()


def ssd_toy_batch(rs, n, size=64):
    """The example's ``make_batch``: images with one rectangle in the
    channel of its class; labels (n, 1, 5) [cls, x1, y1, x2, y2]."""
    import numpy as np
    x = np.zeros((n, 3, size, size), np.float32)
    labels = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        w = rs.randint(size // 4, size // 2)
        h = rs.randint(size // 4, size // 2)
        x0 = rs.randint(0, size - w)
        y0 = rs.randint(0, size - h)
        cls = rs.randint(0, 3)
        x[i, cls, y0:y0 + h, x0:x0 + w] = 1.0
        labels[i, 0] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + h) / size]
    return x, labels


def ssd_toy_heads(nd, net, xb, classes=3):
    """Anchors (1, A, 4), class predictions (B, classes + 1, A) and box
    predictions (B, 4A), position-major as the priors."""
    feat, cls_raw, loc_raw = net(xb)
    B = cls_raw.shape[0]
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=SSD_TOY["sizes"],
                                       ratios=SSD_TOY["ratios"])
    cp = cls_raw.transpose((0, 2, 3, 1)).reshape((B, -1, classes + 1))
    return (anchors, cp.transpose((0, 2, 1)),
            loc_raw.transpose((0, 2, 3, 1)).reshape((B, -1)))


def ssd_toy_objective(nd, gluon, net, xb, lb):
    """The example's loss; returns it and ``MultiBoxTarget``'s inputs and
    outputs."""
    cls_loss = gluon.loss.SoftmaxCrossEntropyLoss()
    loc_loss = gluon.loss.HuberLoss()
    anchors, cls_preds, loc_preds = ssd_toy_heads(nd, net, xb)
    loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
        anchors, lb, cls_preds, negative_mining_ratio=3.0)
    valid = cls_t >= 0
    lc = cls_loss(cls_preds.transpose((0, 2, 1)), nd.relu(cls_t),
                  sample_weight=valid)
    ll = loc_loss(loc_preds * loc_m, loc_t * loc_m)
    A = cls_t.shape[1]
    num_pos = nd.sum(loc_m) / 4.0 + 1.0
    loss = (nd.sum(lc) + nd.sum(ll)) * A / (num_pos * cls_t.shape[0])
    return loss, (anchors, lb, cls_preds, loc_t, loc_m, cls_t)


def ssd_toy_loss(nd, autograd, gluon, net, xb, lb):
    """One recorded step of the example's loss and its backward; returns
    the loss and ``MultiBoxTarget``'s inputs and outputs."""
    with autograd.record():
        loss, mbt = ssd_toy_objective(nd, gluon, net, xb, lb)
    loss.backward()
    return loss, mbt


def ssd_toy_eval(nd, autograd, net, xe, le, eval_iou):
    """The example's evaluation: each image's top detection against its
    box; (mean IoU, class-and-IoU hits)."""
    import numpy as np
    with autograd.predict_mode():
        anchors, cls_preds, loc_preds = ssd_toy_heads(nd, net, xe)
        det = nd.contrib.MultiBoxDetection(nd.softmax(cls_preds, axis=1),
                                           loc_preds, anchors,
                                           nms_threshold=0.45)
    d = det.asnumpy()
    ious, hits = [], 0
    for i in range(d.shape[0]):
        rows = d[i][d[i][:, 0] >= 0]
        if not len(rows):
            ious.append(0.0)
            continue
        best, gt = rows[0], le[i, 0]
        x1, y1 = max(best[2], gt[1]), max(best[3], gt[2])
        x2, y2 = min(best[4], gt[3]), min(best[5], gt[4])
        inter = max(0, x2 - x1) * max(0, y2 - y1)
        a1 = (best[4] - best[2]) * (best[5] - best[3])
        a2 = (gt[3] - gt[1]) * (gt[4] - gt[2])
        iou = inter / max(a1 + a2 - inter, 1e-9)
        ious.append(iou)
        hits += int(best[0] == gt[0] and iou > eval_iou)
    return float(np.mean(ious)), hits


def gluon_copy(src, dst):
    """``dst``'s parameters set to ``src``'s (matched by name past the
    top-level prefix), copied to ``dst``'s device."""
    from mxtpu_torch import nd
    sp = {k.split("_", 1)[1]: v for k, v in src.collect_params().items()}
    for k, v in dst.collect_params().items():
        v.set_data(nd.array(sp[k.split("_", 1)[1]].data().asnumpy(),
                            ctx=v.data().context))


def det_ssd_toy(torch, mx, ctx):
    """(a) examples/train_ssd_toy.py on ``ctx``: 150 steps of B16 SGD
    (momentum 0.9, lr 0.4); the first step's ``MultiBoxTarget`` and the
    first 3 losses against the CPU from the same weights."""
    import numpy as np
    from mxtpu_torch import autograd, gluon, nd
    from mxtpu_torch.ops import detection as td
    c = SSD_TOY
    B, A = c["batch"], len(c["sizes"]) + len(c["ratios"]) - 1
    mx.rng.seed(0)
    rs = np.random.RandomState(0)
    batches = [ssd_toy_batch(rs, B) for _ in range(c["steps"])]
    xe, le = ssd_toy_batch(rs, c["eval_n"])
    net = ssd_toy_net(gluon, c["classes"], A)
    net.initialize(ctx=ctx)
    net(nd.array(batches[0][0], ctx=ctx))          # complete the shapes
    cpu_net = ssd_toy_net(gluon, c["classes"], A)
    cpu_net.initialize(ctx=mx.cpu())
    with mx.Context("cpu"):
        cpu_net(nd.array(batches[0][0]))
    gluon_copy(net, cpu_net)
    sgd = {"learning_rate": c["lr"], "momentum": c["momentum"]}
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(sgd))
    losses, t0 = [], None
    for step, (xb, lb) in enumerate(batches):
        if step == 3:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        loss, mbt = ssd_toy_loss(nd, autograd, gluon, net,
                                 nd.array(xb, ctx=ctx), nd.array(lb, ctx=ctx))
        tr.step(B)
        losses.append(float(loss.asscalar()))
        if step == 0:
            anchors, lbl, cls_preds, loc_t, loc_m, cls_t = [
                a.data for a in mbt]
            ref = td._multibox_target(anchors.cpu(), lbl.cpu(),
                                      cls_preds.detach().cpu(),
                                      negative_mining_ratio=3.0)
            check(torch.equal(cls_t.cpu(), ref[2]) and
                  torch.equal(loc_m.cpu(), ref[1]),
                  "ssd toy: step 1's MultiBoxTarget class targets or masks "
                  "differ between card and CPU")
            lerr = float((loc_t.cpu() - ref[0]).abs().max())
            check(lerr <= 1e-6, f"ssd toy: step 1's loc targets differ by "
                                f"{lerr} (> 1e-6)")
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / (c["steps"] - 3)
    check(all(math.isfinite(v) for v in losses), f"ssd toy: loss {losses}")
    with mx.Context("cpu"):
        ctr = gluon.Trainer(cpu_net.collect_params(), "sgd", dict(sgd))
        cpu_losses = []
        for xb, lb in batches[:c["cpu_steps"]]:
            loss, _ = ssd_toy_loss(nd, autograd, gluon, cpu_net,
                                   nd.array(xb), nd.array(lb))
            ctr.step(B)
            cpu_losses.append(float(loss.asscalar()))
    for i, (g, h) in enumerate(zip(losses, cpu_losses)):
        check(abs(g - h) <= c["loss_rel"] * max(abs(h), 1.0),
              f"ssd toy: step {i + 1} loss {g} on the card, {h} on the CPU")
    iou, hits = ssd_toy_eval(nd, autograd, net, nd.array(xe, ctx=ctx), le,
                             c["eval_iou"])
    check(iou > c["iou_bar"], f"ssd toy: mean IoU {iou:.3f} <= "
                              f"{c['iou_bar']}")
    print(f"detection (a) ssd toy: {c['steps']} steps B{B}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {step_ms:.2f} ms a step, "
          f"mean IoU {iou:.3f} (> {c['iou_bar']}), hits {hits}/"
          f"{c['eval_n']}; step 1 MultiBoxTarget card = CPU (loc_t max "
          f"err {lerr:.2e}); losses 1-3 card {losses[:3]} CPU {cpu_losses}",
          flush=True)
    return dict(step_ms=step_ms, iou=iou, hits=hits)


def det_records(tmp):
    """(b)'s ``.rec``: 64 toy images (``make_batch``) as PNGs through the
    port's ``pack_img``, labels ``[2, 5, cls, x1, y1, x2, y2]``."""
    import numpy as np
    from mxtpu_torch import recordio
    c = DET_REC
    x, labels = ssd_toy_batch(np.random.RandomState(c["seed"]), c["n"],
                              c["size"])
    path = os.path.join(tmp, "det.rec")
    with recordio.MXRecordIO(path, "w") as w:
        for i in range(c["n"]):
            img = (x[i].transpose(1, 2, 0) * 255).astype(np.uint8)
            raw = np.concatenate([[2, 5], labels[i].ravel()])
            w.write(recordio.pack_img(recordio.IRHeader(
                0, raw.astype(np.float32), i, 0), img, img_fmt=".png"))
    return path


def det_box_extent(torch, data, label):
    """The worst distance, in pixels, between each label's box and the
    extent of its rectangle (channel ``cls``, pixels over half) in the
    image."""
    worst = 0.0
    size = data.shape[-1]
    for img, lab in zip(data, label):
        for row in lab[lab[:, 0] >= 0]:
            on = img[int(row[0])] > 127.5
            ys = torch.nonzero(on.any(1)).flatten()
            xs = torch.nonzero(on.any(0)).flatten()
            check(len(ys) and len(xs), "image det: a label's rectangle is "
                                       "not in its image")
            got = [float(xs[0]), float(ys[0]), float(xs[-1]) + 1,
                   float(ys[-1]) + 1]
            want = [float(v) * size for v in row[1:5]]
            worst = max(worst, max(abs(a - b) for a, b in zip(got, want)))
    return worst


def det_image_iter(torch, mx, tmp, ctx):
    """(b) ``ImageDetIter`` with ``rand_mirror`` and ``rand_crop`` over
    the ``.rec``, staged to ``ctx`` and fed to ``MultiBoxTarget``; the
    batches against the CPU path's under the same seed, and every label's
    box against its rectangle in the image."""
    import random
    from mxtpu_torch import image, nd
    c = DET_REC
    rec = det_records(tmp)

    def epoch(stage):
        random.seed(c["seed"])
        t0 = time.monotonic()
        it = image.ImageDetIter(c["batch"], (3, c["size"], c["size"]),
                                path_imgrec=rec, rand_mirror=True,
                                rand_crop=1.0, shuffle=True,
                                preprocess_threads=4)
        t1 = time.monotonic()
        out = []
        for b in it:
            d, l = b.data[0].data, b.label[0].data
            out.append((d.to(ctx), l.to(ctx)) if stage else (d, l))
        return out, it, (t1 - t0) * 1e3, (time.monotonic() - t1) * 1e3

    card, it, build_ms, ms = epoch(True)
    ms /= len(card)
    host = epoch(False)[0]
    anchors = nd.contrib.MultiBoxPrior(nd.zeros((1, 1, 8, 8), ctx=ctx),
                                       sizes=SSD_TOY["sizes"],
                                       ratios=SSD_TOY["ratios"])
    cls_preds = nd.zeros((c["batch"], SSD_TOY["classes"] + 1,
                          anchors.shape[1]), ctx=ctx)
    worst, positives = 0.0, 0
    for (d, l), (dh, lh) in zip(card, host):
        check(torch.equal(d.cpu(), dh) and torch.equal(l.cpu(), lh),
              "image det: a staged batch differs from the CPU path's")
        worst = max(worst, det_box_extent(torch, dh, lh))
        t = nd.contrib.MultiBoxTarget(anchors, nd.NDArray(l), cls_preds,
                                      negative_mining_ratio=3.0)
        h = nd.contrib.MultiBoxTarget(
            anchors.as_in_context(mx.cpu()), nd.NDArray(lh),
            cls_preds.as_in_context(mx.cpu()), negative_mining_ratio=3.0)
        lerr = float((t[0].data.cpu() - h[0].data).abs().max())
        check(torch.equal(t[1].data.cpu(), h[1].data) and
              torch.equal(t[2].data.cpu(), h[2].data) and lerr <= 1e-6,
              "image det: MultiBoxTarget differs between card and CPU")
        positives += int((t[2].data > 0).sum())
    check(worst <= 1.0, f"image det: a label's box is {worst:.2f} px from "
                        f"its rectangle's extent (> 1)")
    check(positives > 0, "image det: MultiBoxTarget matched nothing")
    print(f"detection (b) ImageDetIter: {c['n']} PNG records, "
          f"{len(card)} batches of {c['batch']} (rand_crop, rand_mirror), "
          f"{ms:.1f} ms a batch read, augmented and staged (the iterator "
          f"built in {build_ms:.1f} ms), label shape "
          f"{it.label_shape}; staged batches = the CPU path's; boxes within "
          f"{worst:.2f} px of their rectangles; {positives} positive "
          f"anchors", flush=True)
    return ms


def rcnn_batch(rs, n):
    """examples/train_rcnn_toy.py's ``make_batch``: one rectangle an
    image; images, gt corner boxes (pixels), classes."""
    import numpy as np
    size = RCNN_TOY["size"]
    x = np.zeros((n, 3, size, size), np.float32)
    boxes = np.zeros((n, 4), np.float32)
    cls = np.zeros((n,), np.float32)
    for i in range(n):
        w = rs.randint(size // 4, size // 2)
        h = rs.randint(size // 4, size // 2)
        x0 = rs.randint(0, size - w)
        y0 = rs.randint(0, size - h)
        c = rs.randint(0, 3)
        x[i, c, y0:y0 + h, x0:x0 + w] = 1.0
        boxes[i] = [x0, y0, x0 + w - 1, y0 + h - 1]
        cls[i] = c
    return x, boxes, cls


def rcnn_targets(anchors, gt_boxes, feat, A):
    """The example's host-side RPN targets (AnchorLoader): objectness
    labels {1, 0, -1} and box targets and weights in the heads' layouts."""
    import numpy as np
    n, K = gt_boxes.shape[0], anchors.shape[0]
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1)
    ay = anchors[:, 1] + 0.5 * (ah - 1)
    labels = np.full((n, K), -1.0, np.float32)
    targets = np.zeros((n, K, 4), np.float32)
    weights = np.zeros((n, K, 4), np.float32)
    for i in range(n):
        g = gt_boxes[i]
        ix1 = np.maximum(anchors[:, 0], g[0])
        iy1 = np.maximum(anchors[:, 1], g[1])
        ix2 = np.minimum(anchors[:, 2], g[2])
        iy2 = np.minimum(anchors[:, 3], g[3])
        inter = np.clip(ix2 - ix1 + 1, 0, None) * \
            np.clip(iy2 - iy1 + 1, 0, None)
        area_g = (g[2] - g[0] + 1) * (g[3] - g[1] + 1)
        iou = inter / (aw * ah + area_g - inter)
        neg = iou < 0.3
        pos = iou >= 0.5
        pos[np.argmax(iou)] = True
        neg_idx = np.flatnonzero(neg & ~pos)
        keep = min(len(neg_idx), 3 * int(pos.sum()) + 4)
        neg_keep = np.random.RandomState(i + 1).choice(neg_idx, keep,
                                                       replace=False)
        labels[i, neg_keep] = 0.0
        labels[i, pos] = 1.0
        gw, gh = g[2] - g[0] + 1.0, g[3] - g[1] + 1.0
        gx, gy = g[0] + 0.5 * (gw - 1), g[1] + 0.5 * (gh - 1)
        targets[i, :, 0] = (gx - ax) / aw
        targets[i, :, 1] = (gy - ay) / ah
        targets[i, :, 2] = np.log(gw / aw)
        targets[i, :, 3] = np.log(gh / ah)
        weights[i, pos] = 1.0
    lab = labels.reshape(n, feat, feat, A).transpose(0, 3, 1, 2).reshape(
        n, -1)
    tgt = targets.reshape(n, feat, feat, A * 4).transpose(0, 3, 1, 2)
    wgt = weights.reshape(n, feat, feat, A * 4).transpose(0, 3, 1, 2)
    return lab, tgt, wgt


def rcnn_symbol(sym, batch, num_classes=3):
    """examples/train_rcnn_toy.py's ``build_symbol`` in the port's
    ``sym``: backbone, RPN losses, ``contrib.Proposal``, the in-graph
    proposal targets, ``ROIPooling`` and the classifier head."""
    c = RCNN_TOY
    A = len(c["scales"]) * len(c["ratios"])
    feat_n = c["size"] // c["stride"]
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    rpn_label = sym.Variable("rpn_label")
    bbox_target = sym.Variable("bbox_target")
    bbox_weight = sym.Variable("bbox_weight")
    gt_boxes = sym.Variable("gt_boxes")
    gt_cls = sym.Variable("gt_cls")
    x = data
    for i, ch in enumerate((16, 32, 64)):
        x = sym.Convolution(x, num_filter=ch, kernel=(3, 3), stride=(2, 2),
                            pad=(1, 1), name=f"conv{i}")
        x = sym.Activation(x, act_type="relu")
    feat = x
    rpn = sym.Activation(
        sym.Convolution(feat, num_filter=32, kernel=(3, 3), pad=(1, 1),
                        name="rpn_conv"), act_type="relu")
    score = sym.Convolution(rpn, num_filter=2 * A, kernel=(1, 1),
                            name="rpn_cls_score")
    bbox = sym.Convolution(rpn, num_filter=4 * A, kernel=(1, 1),
                           name="rpn_bbox_pred")
    score_rs = sym.reshape(score, shape=(batch, 2, A * feat_n * feat_n))
    rpn_cls_loss = sym.SoftmaxOutput(score_rs, rpn_label, multi_output=True,
                                     use_ignore=True, ignore_label=-1,
                                     normalization="valid",
                                     name="rpn_cls_loss")
    rpn_bbox_loss = sym.make_loss(
        sym.sum(sym.smooth_l1((bbox - bbox_target) * bbox_weight,
                              scalar=3.0)),
        grad_scale=1.0 / batch, name="rpn_bbox_loss")
    prob = sym.softmax(score_rs, axis=1)
    prob4 = sym.reshape(prob, shape=(batch, 2 * A, feat_n, feat_n))
    rois = sym.contrib.Proposal(
        cls_prob=sym.BlockGrad(prob4), bbox_pred=sym.BlockGrad(bbox),
        im_info=im_info, feature_stride=c["stride"], scales=c["scales"],
        ratios=c["ratios"], rpn_pre_nms_top_n=32,
        rpn_post_nms_top_n=c["post"], threshold=0.7, rpn_min_size=4,
        name="proposal")
    roi_boxes = sym.slice_axis(rois, axis=1, begin=1, end=5)
    roi_img = sym.reshape(sym.slice_axis(rois, axis=1, begin=0, end=1),
                          shape=(batch * c["post"],))
    iou = sym.contrib.box_iou(roi_boxes, gt_boxes, format="corner")
    own_iou = sym.pick(iou, roi_img)
    roi_gt = sym.take(gt_cls, roi_img)
    roi_label = sym.where(own_iou > 0.5, roi_gt + 1.0,
                          sym.zeros_like(roi_gt))
    pooled = sym.ROIPooling(sym.BlockGrad(feat), rois, pooled_size=(4, 4),
                            spatial_scale=1.0 / c["stride"])
    h1 = sym.Activation(sym.FullyConnected(sym.Flatten(pooled),
                                           num_hidden=64, name="fc6"),
                        act_type="relu")
    cls_score = sym.FullyConnected(h1, num_hidden=num_classes + 1,
                                   name="cls")
    roi_cls_loss = sym.SoftmaxOutput(cls_score, sym.BlockGrad(roi_label),
                                     grad_scale=1.0, normalization="batch",
                                     name="roi_cls_loss")
    return sym.Group([rpn_cls_loss, rpn_bbox_loss, roi_cls_loss,
                      sym.BlockGrad(rois), sym.BlockGrad(roi_label)])


def threefry2x32(key, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x1, x2)`` under
    ``key``, in numpy uint32: the generator behind JAX's default key."""
    import numpy as np
    u = np.uint32
    ks = (u(key[0]), u(key[1]), u(key[0]) ^ u(key[1]) ^ u(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = ((x[1] << u(r)) | (x[1] >> u(32 - r))) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + u(i + 1)
    return x


def example_xavier(shapes, seed, magnitude):
    """The weights the JAX package's ``mx.rng.seed(seed)`` and then
    ``Xavier(magnitude=magnitude)`` (uniform, averaged fans) draw for
    ``shapes`` in order, reproduced in numpy, bit for bit: each draw
    splits the global key and fills the shape with the subkey's uniform
    bits, as ``jax.random`` does with partitionable threefry; the scale
    and shift are one fused multiply-add, as XLA compiles them."""
    import numpy as np

    def bits(key, n):
        i = np.arange(n, dtype=np.uint64)
        return threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    key, out = (0, seed), []
    for shape in shapes:
        k1, k2 = bits(key, 2)
        key, sub = (k1[0], k2[0]), (k1[1], k2[1])
        b1, b2 = bits(sub, int(np.prod(shape)))
        unit = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32) - np.float32(1.0)
        hw = int(np.prod(shape[2:]))
        fans = (shape[1] * hw + shape[0] * hw) / 2.0
        scale = math.sqrt(magnitude / max(fans, 1.0))
        lo, hi = np.float32(-scale), np.float32(scale)
        w = (unit.astype(np.float64) * np.float64(hi - lo)
             + np.float64(lo)).astype(np.float32)
        out.append(np.maximum(lo, w).reshape(shape))
    return out


def rcnn_toy_train(torch, mx, ctx, steps, start=None):
    """examples/train_rcnn_toy.py's ``main`` on ``ctx``: its graph through
    ``simple_bind``, its initial weights (``example_xavier`` of
    ``mx.rng.seed(0)``, zero biases), its batches, and plain SGD on the
    executor's arrays. ``start``, where given, holds for each step the
    weights (numpy, by name) that the step starts from in place of the
    run's own. Returns each step's (rpn_acc, roi_acc, pos_frac), the
    final weights as numpy arrays and the ms a step."""
    import numpy as np
    from mxtpu_torch import nd, symbol
    from mxtpu_torch.ops import detection as td
    c = RCNN_TOY
    N, A = c["batch"], len(c["scales"]) * len(c["ratios"])
    feat_n = c["size"] // c["stride"]
    rs = np.random.RandomState(0)
    out = rcnn_symbol(symbol, N)
    anchors = td._rpn_anchors(feat_n, feat_n, c["stride"], c["scales"],
                              c["ratios"]).numpy()
    shapes = {"data": (N, 3, c["size"], c["size"]), "im_info": (N, 3),
              "rpn_label": (N, A * feat_n * feat_n),
              "bbox_target": (N, 4 * A, feat_n, feat_n),
              "bbox_weight": (N, 4 * A, feat_n, feat_n),
              "gt_boxes": (N, 4), "gt_cls": (N,)}
    grad_req = {n: ("null" if n in shapes else "write")
                for n in out.list_arguments()}
    ex = out.simple_bind(ctx=ctx, grad_req=grad_req, **shapes)
    weights = [n for n in out.list_arguments() if n not in shapes]
    drawn = [n for n in weights if not n.endswith("_bias")]
    init = dict(zip(drawn, example_xavier(
        [ex.arg_dict[n].shape for n in drawn], 0, 2.0)))
    for n in weights:
        w0 = init.get(n, np.zeros(ex.arg_dict[n].shape, np.float32))
        ex.arg_dict[n]._set_data(torch.from_numpy(w0).to(
            ex.arg_dict[n].data.device))
    im_info = np.tile([c["size"], c["size"], 1.0], (N, 1)).astype(np.float32)
    hist = []
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.monotonic()
    for step in range(steps):
        for n, v in (start[step] if start else {}).items():
            ex.arg_dict[n]._set_data(torch.from_numpy(v).to(
                ex.arg_dict[n].data.device))
        imgs, gtb, gtc = rcnn_batch(rs, N)
        lab, tgt, wgt = rcnn_targets(anchors, gtb, feat_n, A)
        feed = dict(data=imgs, im_info=im_info, rpn_label=lab,
                    bbox_target=tgt, bbox_weight=wgt, gt_boxes=gtb,
                    gt_cls=gtc)
        ex.forward(is_train=True, **{k: nd.array(v, ctx=ctx)
                                     for k, v in feed.items()})
        ex.backward()
        for n in weights:
            ex.arg_dict[n]._set_data(
                ex.arg_dict[n].data - c["lr"] * ex.grad_dict[n].data)
        rpn_prob, _, roi_prob, _, roi_label = [o.asnumpy()
                                               for o in ex.outputs]
        labeled = lab >= 0
        hist.append((
            float((((rpn_prob[:, 1, :] > 0.5) == (lab > 0.5))
                   & labeled).sum() / max(labeled.sum(), 1)),
            float((roi_prob.argmax(axis=1) == roi_label).mean()),
            float((roi_label > 0).mean())))
    step_ms = (time.monotonic() - t0) * 1e3 / steps
    return hist, {n: ex.arg_dict[n].asnumpy() for n in weights}, step_ms


def det_rcnn_toy(torch, mx, ctx):
    """(c) examples/train_rcnn_toy.py on ``ctx`` from its own initial
    weights: B8, 150 steps of SGD at lr 0.05; the last step's accuracies
    against ``tests/test_examples.py``'s bars."""
    import numpy as np
    from mxtpu_torch.ops import detection as td
    c = RCNN_TOY
    N, A = c["batch"], len(c["scales"]) * len(c["ratios"])
    feat_n = c["size"] // c["stride"]
    hist, _, step_ms = rcnn_toy_train(torch, mx, ctx, c["steps"])
    # the same run on the CPU: the first step whose accuracies differ
    # (a last-bit difference can move a proposal across the IoU bound and
    # send the runs their own ways), printed, not held
    cpu_hist, _, _ = rcnn_toy_train(torch, mx, mx.cpu(), c["steps"])
    apart = next((i + 1 for i, (a, b) in enumerate(zip(hist, cpu_hist))
                  if a != b), None)
    rpn_acc, roi_acc, pos_frac = hist[-1]
    tail = [sum(v) / c["tail"] for v in zip(*hist[-c["tail"]:])]
    check(rpn_acc > c["rpn_acc"] and roi_acc > c["roi_acc"]
          and pos_frac > c["pos_frac"],
          f"rcnn toy: the last step's rpn_acc {rpn_acc:.3f} "
          f"(> {c['rpn_acc']}), roi_acc {roi_acc:.3f} (> {c['roi_acc']}), "
          f"pos_frac {pos_frac:.3f} (> {c['pos_frac']})")
    print(f"detection (c) rcnn toy (simple_bind, B{N}, {c['steps']} steps, "
          f"lr {c['lr']}): the last step's rpn_acc {rpn_acc:.3f} roi_acc "
          f"{roi_acc:.3f} pos_frac {pos_frac:.3f} (over the last "
          f"{c['tail']} steps {tail[0]:.3f} {tail[1]:.3f} {tail[2]:.3f}), "
          f"{step_ms:.1f} ms a step (host feed and targets included); "
          f"the CPU's run from the same weights "
          + (f"reads the same accuracies at all {c['steps']} steps"
             if apart is None else
             f"first reads other accuracies at step {apart} and ends at "
             f"{cpu_hist[-1][0]:.3f} {cpu_hist[-1][1]:.3f} "
             f"{cpu_hist[-1][2]:.3f}"), flush=True)
    # Proposal on the card against the CPU, on the toy's shapes
    g = torch.Generator().manual_seed(19)
    prob = torch.rand(N, 2 * A, feat_n, feat_n, generator=g)
    bb = torch.randn(N, 4 * A, feat_n, feat_n, generator=g) * 0.3
    im_info = torch.tensor([[c["size"], c["size"], 1.0]] * N)
    kw = dict(feature_stride=c["stride"], scales=c["scales"],
              ratios=c["ratios"], rpn_pre_nms_top_n=32,
              rpn_post_nms_top_n=c["post"], threshold=0.7, rpn_min_size=4)
    proposal_card_vs_cpu(torch, td, [prob, bb, im_info], kw, "rcnn toy")
    return dict(step_ms=step_ms, rpn_acc=rpn_acc, roi_acc=roi_acc,
                pos_frac=pos_frac)


def keep_root(torch, what, boxes, keep_c, keep_h, thr, same=None):
    """Card and CPU keep masks (B, n) of one greedy suppression over the
    CPU's sorted ``boxes`` (B, n, 4). Where they differ, the first differing
    row must be one whose largest IoU with an earlier kept row (of its class
    where ``same`` (B, n) gives classes) lies within ``DET_KEEP_TOL`` of
    ``thr``: the two devices' boxes differ in their last bits, and only such
    a pair can take another side of the threshold. Returns the batch rows
    whose masks agree."""
    from mxtpu_torch.ops import detection as td
    keep_c = keep_c.cpu()
    agree = []
    for b in range(keep_h.shape[0]):
        diff = torch.nonzero(keep_c[b] != keep_h[b]).flatten()
        if not len(diff):
            agree.append(b)
            continue
        i = int(diff[0])
        prev = torch.nonzero(keep_h[b, :i]).flatten()
        iou = td._pair_iou(boxes[b, i][None], boxes[b, prev])[0]
        if same is not None:
            iou = torch.where(same[b, prev] == same[b, i], iou,
                              torch.zeros_like(iou))
        top = float(iou.max()) if len(prev) else 0.0
        check(abs(top - thr) <= DET_KEEP_TOL,
              f"{what}: batch {b} row {i} kept on one device only, its "
              f"IoU {top:.8f} is not within {DET_KEEP_TOL} of {thr}")
        print(f"{what}: batch {b} row {i}'s keep differs between card and "
              f"CPU at IoU {top:.8f} (threshold {thr})", flush=True)
    return agree


def close(torch, what, got, ref, rtol=DET_RTOL, atol=DET_ATOL):
    """``got`` (card) within ``rtol`` relative + ``atol`` absolute of
    ``ref`` (CPU); returns the largest absolute difference."""
    got = got.detach().cpu()
    ref = ref.detach()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} on "
                                  f"the card, {tuple(ref.shape)} on the CPU")
    err = (got - ref).abs()
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"{what}: card and CPU differ by {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def proposal_card_vs_cpu(torch, td, inputs, kw, what):
    """``Proposal`` on the card against the CPU on ``inputs`` (CPU
    tensors): the sorted boxes within 1e-5 x max, the keep masks under
    ``keep_root``, the rois of agreeing batch rows within 1e-5 x max."""
    pre = dict(rpn_pre_nms_top_n=kw.get("rpn_pre_nms_top_n", 6000),
               threshold=kw.get("threshold", 0.7),
               rpn_min_size=kw.get("rpn_min_size", 16),
               scales=kw["scales"], ratios=kw["ratios"],
               feature_stride=kw["feature_stride"])
    card = [x.cuda() for x in inputs]
    bc, sc, kc = td._proposal_keep(*card, **pre)
    bh, sh, kh = td._proposal_keep(*inputs, **pre)
    scale = float(bh.abs().max())
    close(torch, f"{what} Proposal boxes", bc, bh, 0.0, 1e-5 * scale)
    check(torch.equal(sc.cpu(), sh), f"{what} Proposal: the pre-NMS scores "
                                     f"differ between card and CPU")
    agree = keep_root(torch, f"{what} Proposal", bh, kc, kh, pre["threshold"])
    rc = td._proposal(*card, **kw)
    rh = td._proposal(*inputs, **kw)
    post = kw.get("rpn_post_nms_top_n", 300)
    rows = torch.cat([torch.arange(b * post, (b + 1) * post)
                      for b in agree]) if agree else torch.zeros(0).long()
    err = close(torch, f"{what} Proposal rois", rc.cpu()[rows], rh[rows],
                0.0, 1e-5 * scale)
    return err, len(agree)


def event_ms(torch, fn, reps=3):
    """``timed_ms`` of ``fn`` over ``reps`` calls after one call, and that
    call's result: an eager op's time with its launches and host work."""
    out = fn()
    return timed_ms(torch, fn, reps, warmup=0), out


def ssd300_inputs(torch, g):
    """Random f32 feature maps, 3x3 head weights and padded labels of
    SSD300's detection layer, on the card."""
    c = SSD300
    B, K = c["batch"], c["classes"] + 1
    feats, heads = [], []
    for m, ch, r, s in zip(c["maps"], c["channels"], c["ratios"],
                           c["sizes"]):
        a = len(s) + len(r) - 1
        feats.append(torch.randn(B, ch, m, m, device="cuda", generator=g))
        std = (2.0 / (9 * ch)) ** 0.5
        heads.append([torch.randn(a * K, ch, 3, 3, device="cuda",
                                  generator=g) * std,
                      torch.zeros(a * K, device="cuda"),
                      torch.randn(a * 4, ch, 3, 3, device="cuda",
                                  generator=g) * std,
                      torch.zeros(a * 4, device="cuda")])
    n = torch.randint(1, 13, (B,), generator=g, device="cuda")
    xy = torch.rand(B, c["gts"], 2, device="cuda", generator=g) * 0.7
    wh = torch.rand(B, c["gts"], 2, device="cuda", generator=g) * 0.28 + 0.02
    cls = torch.randint(0, c["classes"], (B, c["gts"], 1), generator=g,
                        device="cuda").float()
    lab = torch.cat([cls, xy, xy + wh], -1)
    pad = torch.arange(c["gts"], device="cuda")[None] >= n[:, None]
    lab[pad] = -1.0
    return feats, heads, lab


def ssd300_layer(torch, mx, smi):
    """(d) SSD300's detection layer at full size on the card: the heads,
    ``MultiBoxPrior`` a map, ``MultiBoxTarget`` (mining ratio 3; eager and
    replayed on a CUDA graph, bit-equal), both losses and backward, then
    ``MultiBoxDetection`` (NMS 0.45, top 400); each op against the CPU on
    the same inputs."""
    from mxtpu_torch import autograd, gluon, nd
    from mxtpu_torch.ops import detection as td
    c = SSD300
    B, K = c["batch"], c["classes"] + 1
    g = torch.Generator(device="cuda").manual_seed(300)
    feats, heads, lab = ssd300_inputs(torch, g)
    feats = [nd.NDArray(f) for f in feats]
    heads = [[nd.NDArray(t) for t in h] for h in heads]
    for h in heads:
        for t in h:
            t.attach_grad()
    ms = {}

    def priors():
        return [nd.contrib.MultiBoxPrior(f, sizes=s, ratios=r)
                for f, s, r in zip(feats, c["sizes"], c["ratios"])]

    ms["MultiBoxPrior"], anc = event_ms(torch, priors)
    anchors = nd.concat(*anc, dim=1)
    A = anchors.shape[1]
    check(A == c["anchors"], f"ssd300: {A} anchors, not {c['anchors']}")
    for a, f, s, r in zip(anc, feats, c["sizes"], c["ratios"]):
        close(torch, "ssd300 MultiBoxPrior", a.data, td._multibox_prior(
            f.data[:1, :1].cpu(), sizes=s, ratios=r))

    def heads_fwd():
        cp, lp = [], []
        for f, (wc, bc, wl, bl) in zip(feats, heads):
            cp.append(nd.Convolution(
                f, wc, bc, kernel=(3, 3), pad=(1, 1),
                num_filter=wc.shape[0]).transpose((0, 2, 3, 1)).reshape(
                    (B, -1, K)))
            lp.append(nd.Convolution(
                f, wl, bl, kernel=(3, 3), pad=(1, 1),
                num_filter=wl.shape[0]).transpose((0, 2, 3, 1)).reshape(
                    (B, -1)))
        return (nd.concat(*cp, dim=1).transpose((0, 2, 1)),
                nd.concat(*lp, dim=1))

    labels = nd.NDArray(lab)
    cls_preds, loc_preds = heads_fwd()

    def target():
        return nd.contrib.MultiBoxTarget(anchors, labels, cls_preds,
                                         negative_mining_ratio=3.0)

    ms["MultiBoxTarget"], (loc_t, loc_m, cls_t) = event_ms(torch, target)
    tin = [anchors.data, lab, cls_preds.data]
    graph, (gout,) = capture(torch, lambda: td._multibox_target(
        *tin, negative_mining_ratio=3.0), 1)
    check(all(torch.equal(a, b.data) for a, b in zip(gout,
                                                      (loc_t, loc_m, cls_t))),
          "ssd300: MultiBoxTarget's CUDA-graph replay differs from the "
          "eager call")
    ms["MultiBoxTarget_graph"] = graph_ms(torch, lambda: td._multibox_target(
        *tin, negative_mining_ratio=3.0), 2)
    href = td._multibox_target(*[t.cpu() for t in tin],
                               negative_mining_ratio=3.0)
    check(torch.equal(loc_m.data.cpu(), href[1]) and
          torch.equal(cls_t.data.cpu(), href[2]),
          "ssd300: MultiBoxTarget's masks or class targets differ between "
          "card and CPU")
    close(torch, "ssd300 MultiBoxTarget loc_t", loc_t.data, href[0])
    cls_loss = gluon.loss.SoftmaxCrossEntropyLoss()
    loc_loss = gluon.loss.HuberLoss()

    def step():
        with autograd.record():
            cp, lp = heads_fwd()
            lt, lm, ct = nd.contrib.MultiBoxTarget(
                anchors, labels, cp, negative_mining_ratio=3.0)
            lc = cls_loss(cp.transpose((0, 2, 1)), nd.relu(ct),
                          sample_weight=ct >= 0)
            ll = loc_loss(lp * lm, lt * lm)
            num_pos = nd.sum(lm) / 4.0 + 1.0
            loss = (nd.sum(lc) + nd.sum(ll)) * A / (num_pos * B)
        loss.backward()
        return loss

    ms["layer_step"], loss = event_ms(torch, step)
    check(math.isfinite(float(loss.asscalar())) and all(
        bool(torch.isfinite(t.grad.data).all()) for h in heads for t in h),
        "ssd300: the layer's loss or gradients are not finite")
    probs = nd.softmax(cls_preds, axis=1)
    kw = dict(nms_threshold=c["nms"], nms_topk=c["nms_topk"])

    def detect():
        return nd.contrib.MultiBoxDetection(probs, loc_preds, anchors, **kw)

    ms["MultiBoxDetection"], det = event_ms(torch, detect)
    din = [probs.data, loc_preds.data, anchors.data]
    dk = dict(clip=True, threshold=0.01, background_id=0,
              nms_threshold=c["nms"], force_suppress=False,
              nms_topk=c["nms_topk"], variances=(0.1, 0.1, 0.2, 0.2))
    cs_c, ss_c, bs_c, keep_c = td._detection_keep(*din, **dk)
    cs_h, ss_h, bs_h, keep_h = td._detection_keep(*[t.cpu() for t in din],
                                                  **dk)
    check(torch.equal(cs_c.cpu(), cs_h) and torch.equal(ss_c.cpu(), ss_h),
          "ssd300: MultiBoxDetection's sorted classes or scores differ "
          "between card and CPU")
    close(torch, "ssd300 MultiBoxDetection boxes", bs_c, bs_h)
    agree = keep_root(torch, "ssd300 MultiBoxDetection", bs_h, keep_c,
                      keep_h, c["nms"], same=cs_h)
    href = td._multibox_detection(*[t.cpu() for t in din], **kw)
    close(torch, "ssd300 MultiBoxDetection rows", det.data[agree],
          href[agree])
    kept = int((det.data[..., 0] >= 0).sum())
    print(f"detection (d) SSD300 layer (B{B}, A {A}, {c['classes']} "
          f"classes, labels padded to {c['gts']}): MultiBoxPrior (6 maps) "
          f"{ms['MultiBoxPrior']:.3f} ms, MultiBoxTarget "
          f"{ms['MultiBoxTarget']:.2f} ms eager, "
          f"{ms['MultiBoxTarget_graph']:.2f} ms replayed (bit-equal), "
          f"heads + target + losses + backward {ms['layer_step']:.2f} ms, "
          f"MultiBoxDetection (top {c['nms_topk']}) "
          f"{ms['MultiBoxDetection']:.2f} ms, {kept} rows kept; card = CPU "
          f"({smi})", flush=True)
    return ms


def frcnn_legs(torch, mx, smi):
    """(d) Faster R-CNN's RPN and pooling at full size: ``Proposal`` on
    (2, 18, 38, 63) (6000 before NMS, 300 after) and ``ROIPooling`` of its
    rois on (2, 512, 38, 63), 7x7 at 1/16, forward and backward; each
    against the CPU; ROIPooling's peak memory."""
    from mxtpu_torch import nd
    from mxtpu_torch.ops import detection as td
    c = FRCNN
    N, A = c["batch"], len(c["scales"]) * len(c["ratios"])
    g = torch.Generator().manual_seed(16)
    logits = torch.randn(N, 2, A, c["h"], c["w"], generator=g)
    prob = torch.softmax(logits, 1).reshape(N, 2 * A, c["h"], c["w"])
    bbox = torch.randn(N, 4 * A, c["h"], c["w"], generator=g) * 0.2
    im_info = torch.tensor([[c["im"][0], c["im"][1], 1.0]] * N)
    kw = dict(feature_stride=c["stride"], scales=c["scales"],
              ratios=c["ratios"], rpn_pre_nms_top_n=c["pre"],
              rpn_post_nms_top_n=c["post"], threshold=c["thr"],
              rpn_min_size=16)
    ms = {}
    card = [nd.NDArray(t.cuda()) for t in (prob, bbox, im_info)]
    ms["Proposal"], rois = event_ms(
        torch, lambda: nd.contrib.Proposal(*card, **kw))
    check(rois.shape == (N * c["post"], 5), f"frcnn: rois {rois.shape}")
    perr, agree = proposal_card_vs_cpu(torch, td, [prob, bbox, im_info], kw,
                                       "frcnn")
    feat = torch.relu(torch.randn(N, c["channels"], c["h"], c["w"],
                                  generator=g))
    cot = torch.randn(N * c["post"], c["channels"], *c["pooled"],
                      generator=g)
    rk = dict(pooled_size=c["pooled"], spatial_scale=1.0 / c["stride"])
    r = rois.data.detach()
    fc, cc = feat.cuda().requires_grad_(True), cot.cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms["ROIPooling"], out = event_ms(
        torch, lambda: td._roi_pooling(fc.detach(), r, **rk))

    def fwd_bwd():
        o = td._roi_pooling(fc, r, **rk)
        return torch.autograd.grad(o, fc, cc)[0]

    ms["ROIPooling_fwd_bwd"], grad = event_ms(torch, fwd_bwd)
    peak = torch.cuda.max_memory_allocated() - base
    check(peak < c["roi_bytes"], f"frcnn: ROIPooling's peak memory "
                                 f"{peak / 2**30:.2f} GiB >= 2 GiB")
    fh = feat.clone().requires_grad_(True)
    oh = td._roi_pooling(fh, r.cpu(), **rk)
    gh = torch.autograd.grad(oh, fh, cot)[0]
    check(torch.equal(out.cpu(), oh.detach()),
          "frcnn: ROIPooling's forward differs between card and CPU")
    # the gradient sums each cell's shares over up to 600 overlapping
    # rois, by atomic adds on the card: reassociation, held at 1e-6 of
    # the largest entry. The spread of two card runs, and each float32
    # gradient's distance from a float64 one on the card, show it.
    gbound = DET_ATOL * float(gh.abs().max())
    gerr = close(torch, "frcnn ROIPooling gradient", grad, gh, DET_RTOL,
                 gbound)
    spread = float((fwd_bwd() - grad).abs().max())
    f64 = fc.detach().double().requires_grad_(True)
    g64 = torch.autograd.grad(td._roi_pooling(f64, r, **rk), f64,
                              cc.double())[0]
    e_card = float((grad.double() - g64).abs().max())
    e_cpu = float((gh.double() - g64.cpu()).abs().max())
    print(f"detection (d) Faster R-CNN (VGG16, 600x1000): Proposal "
          f"({N}x{A}x{c['h']}x{c['w']} = {c['anchors']} anchors, "
          f"{c['pre']} -> NMS -> {c['post']}) {ms['Proposal']:.1f} ms, "
          f"rois within {perr:.2e} of the CPU ({agree}/{N} images' keep "
          f"masks equal); ROIPooling {tuple(out.shape)} "
          f"{ms['ROIPooling']:.2f} ms forward, "
          f"{ms['ROIPooling_fwd_bwd']:.2f} ms forward + backward, peak "
          f"{peak / 2**20:.0f} MiB above its inputs, forward = CPU, gradient "
          f"within {gerr:.2e} of the CPU (bound {gbound:.2e}), two card "
          f"runs {spread:.2e} apart, card and CPU {e_card:.2e} and "
          f"{e_cpu:.2e} from float64 ({smi})", flush=True)
    return dict(ms, roi_peak_mib=peak / 2**20)


def det_op_cases(torch):
    """(e)'s cases, at the CPU tests' shapes: (name, op, inputs, attrs,
    inputs to differentiate, outputs compared exactly, rtol, atol relative
    to the largest entry)."""
    from mxtpu_torch.ops import contrib_ops as tc
    from mxtpu_torch.ops import detection as td
    from mxtpu_torch.ops import order as to
    from mxtpu_torch.ops import spatial as ts
    g = torch.Generator().manual_seed(41)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    def un(lo, hi, *s):
        return torch.rand(*s, generator=g) * (hi - lo) + lo

    def rois(n, hi):
        xy, wh = un(0, hi * 0.7, n, 2), un(1.5, hi * 0.6, n, 2)
        return torch.cat([torch.randint(0, 2, (n, 1), generator=g).float(),
                          xy, xy + wh], 1)

    ties = torch.randint(0, 4, (3, 7), generator=g).float()
    anchors = td._multibox_prior(torch.zeros(1, 1, 4, 4), sizes=(0.3, 0.5),
                                 ratios=(1.0, 2.0))
    A = anchors.shape[1]
    xy, wh = un(0, 0.6, 3, 4, 2), un(0.15, 0.4, 3, 4, 2)
    labels = torch.cat([torch.randint(0, 3, (3, 4, 1), generator=g).float(),
                        xy, xy + wh], -1)
    labels[0, 3:] = -1
    labels[2] = -1
    ctr = un(2, 8, 2, 12, 2)
    wh2 = un(1.0, 3.0, 2, 12, 2)
    det_rows = torch.cat([torch.randint(0, 2, (2, 12, 1), generator=g).float(),
                          torch.round(un(0, 1, 2, 12, 1) * 10) / 10,
                          ctr - wh2 / 2, ctr + wh2 / 2], -1)
    rpn = [torch.round(un(0, 1, 2, 12, 5, 6) * 10) / 10, rn(2, 24, 5, 6,
                                                            scale=0.3),
           torch.tensor([[40.0, 48.0, 1.0], [36.0, 44.0, 1.5]])]
    rpn_kw = dict(scales=(2, 4), ratios=(0.5, 1, 2), feature_stride=8,
                  rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12,
                  threshold=0.6, rpn_min_size=4, output_score=True)
    box_a = torch.cat([un(0, 5, 2, 4, 2), un(5.5, 9, 2, 4, 2)], -1)
    box_b = torch.cat([un(0, 5, 2, 3, 2), un(5.5, 9, 2, 3, 2)], -1)
    theta = torch.tensor([[1.0, 0, 0, 0, 1.0, 0]] * 2) + rn(2, 6, scale=0.2)
    E = 1e-5
    return [
        ("sort", to._sort, [ties], dict(axis=-1), (0,), (), E, 0),
        ("sort desc", to._sort, [ties], dict(axis=None, is_ascend=False),
         (0,), (), E, 0),
        ("argsort", to._argsort, [ties], dict(axis=0, is_ascend=False), (),
         (0,), E, 0),
        ("topk both", to._topk, [ties], dict(k=3, ret_typ="both"), (0,),
         (1,), E, 0),
        ("topk mask", to._topk, [ties], dict(k=2, axis=0, ret_typ="mask"),
         (), (0,), E, 0),
        ("ctc_loss", tc._ctc_loss, [rn(10, 3, 5), torch.tensor(
            [[1.0, 1, 2], [3, 4, 0], [2, 3, 2]]), torch.tensor(
            [10.0, 8, 9]), torch.tensor([3.0, 2, 3])], {}, (0,), (), 1e-4, 0),
        ("BilinearResize2D", tc._bilinear_resize, [rn(2, 3, 9, 8)],
         dict(height=4, width=11), (0,), (), E, 0),
        ("AdaptiveAvgPooling2D", tc._adaptive_avg_pool, [rn(2, 3, 5, 7)],
         dict(output_size=(2, 3)), (0,), (), E, 0),
        ("ROIAlign", tc._roi_align, [rn(2, 3, 8, 9), rois(4, 8)],
         dict(pooled_size=(3, 2), spatial_scale=0.9), (0, 1), (), E, 0),
        ("box_iou", tc._box_iou, [box_a, box_b], dict(format="center"),
         (0, 1), (), E, 0),
        ("box_nms", tc._box_nms, [det_rows], dict(
            overlap_thresh=0.4, valid_thresh=0.05, id_index=0), (), (0,), E,
         0),
        ("bipartite_matching", tc._bipartite_matching,
         [torch.round(un(0, 1, 2, 5, 4) * 10) / 10], dict(threshold=0.1),
         (), (0, 1), E, 0),
        ("count_sketch", tc._count_sketch, [rn(3, 6), torch.randint(
            0, 4, (6,), generator=g).float(), torch.ones(6)],
         dict(out_dim=4), (0,), (), E, 0),
        ("getnnz", tc._getnnz, [torch.relu(rn(3, 6))], dict(axis=1), (),
         (0,), E, 0),
        ("quadratic", tc._quadratic, [rn(3, 6)], dict(a=0.5, b=-2.0, c=1.5),
         (0,), (), E, 0),
        ("MultiBoxPrior", td._multibox_prior, [torch.zeros(1, 2, 5, 4)],
         dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5)), (), (), E, 0),
        ("MultiBoxTarget", td._multibox_target, [anchors, labels,
                                                 rn(3, 4, A)],
         dict(negative_mining_ratio=3.0), (), (1, 2), E, 0),
        ("MultiBoxDetection", td._multibox_detection, [
            torch.round(un(0, 1, 2, 4, A) * 100) / 100, rn(2, 4 * A,
                                                            scale=0.5),
            anchors], dict(nms_threshold=0.3, nms_topk=12), (), (), E, 0),
        ("Proposal", td._proposal, rpn, rpn_kw, (), (1,), E, 0),
        ("ROIPooling", td._roi_pooling, [torch.relu(rn(2, 3, 9, 11)),
                                         rois(5, 18)],
         dict(pooled_size=(3, 4), spatial_scale=0.5), (0,), (0,), E, 0),
        ("PSROIPooling", td._psroi_pooling, [rn(2, 18, 8, 8), rois(4, 16)],
         dict(spatial_scale=0.5, output_dim=2, pooled_size=3), (0,), (), E,
         0),
        ("DeformableConvolution", td._deformable_convolution,
         [rn(2, 4, 6, 6), rn(2, 16, 7, 7, scale=0.7), rn(6, 2, 2, 2,
                                                          scale=0.3), rn(6)],
         dict(kernel=(2, 2), pad=(1, 1), num_filter=6, num_group=2,
              num_deformable_group=2), (0, 1, 2, 3), (), E, 0),
        ("DeformablePSROIPooling", td._deformable_psroi_pooling,
         [rn(2, 18, 8, 8), rois(3, 16), rn(3, 2, 3, 3, scale=0.5)],
         dict(spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3,
              sample_per_part=2, trans_std=0.1), (0, 2), (), E, 0),
        ("GridGenerator", ts._grid_generator, [theta],
         dict(transform_type="affine", target_shape=(4, 5)), (0,), (), E, 0),
        ("GridGenerator warp", ts._grid_generator, [rn(2, 2, 4, 5)],
         dict(transform_type="warp"), (0,), (), E, 0),
        ("BilinearSampler", ts._bilinear_sampler, [rn(2, 3, 5, 6),
                                                   un(-1.2, 1.2, 2, 2, 4, 4)],
         {}, (0, 1), (), E, 0),
        ("SpatialTransformer", ts._spatial_transformer, [rn(2, 3, 5, 6),
                                                         theta],
         dict(target_shape=(4, 4)), (0, 1), (), E, 0),
        ("Correlation", ts._correlation, [rn(2, 3, 7, 8), rn(2, 3, 7, 8)],
         dict(kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
         (0, 1), (), E, 0),
        ("fft", ts._fft, [rn(3, 8)], {}, (0,), (), E, 1),
        ("ifft", ts._ifft, [rn(3, 16)], {}, (0,), (), E, 1),
    ]


def det_ops_card_vs_cpu(torch, smi):
    """(e) every op of ``order``, ``contrib_ops``, ``detection`` and
    ``spatial`` on the card against the CPU on the same inputs: outputs
    and gradients of ``sum(out * c)`` within rtol + 1e-6 absolute (that
    times the largest entry for ``fft``/``ifft``), indices, masks, keep
    sets and integer outputs exact."""
    n = 0
    for name, fn, ins, kw, grad, exact, rtol, scaled in det_op_cases(torch):
        res = {}
        g = torch.Generator().manual_seed(n)
        for dev in ("cuda", "cpu"):
            xs = [t.detach().to(dev).requires_grad_(i in grad)
                  for i, t in enumerate(ins)]
            with torch.set_grad_enabled(bool(grad)):
                out = fn(*xs, **kw)
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            gs = ()
            if grad:
                if dev == "cuda":
                    cots = [torch.randn(o.shape, generator=g) for o in out]
                loss = sum((o * c.to(dev)).sum() for o, c in zip(out, cots)
                           if o.requires_grad)
                gs = torch.autograd.grad(loss, [xs[i] for i in grad],
                                         allow_unused=True)
            res[dev] = (out, gs)
        (oc, gc), (oh, gh) = res["cuda"], res["cpu"]
        for k, (a, b) in enumerate(zip(oc, oh)):
            if k in exact:
                check(torch.equal(a.detach().cpu(), b.detach()),
                      f"(e) {name}: output {k} differs between card and CPU")
            else:
                s = max(float(b.detach().abs().max()), 1.0) if scaled else 1.0
                close(torch, f"(e) {name} output {k}", a, b, rtol,
                      DET_ATOL * s)
        for i, a, b in zip(grad, gc, gh):
            if a is None or b is None:
                check(a is None and b is None, f"(e) {name}: gradient {i}")
                continue
            s = max(float(b.abs().max()), 1.0) if scaled else 1.0
            close(torch, f"(e) {name} gradient {i}", a, b, rtol, DET_ATOL * s)
        n += 1
    print(f"detection (e): {n} op cases of order, contrib_ops, detection "
          f"and spatial, card = CPU (outputs and gradients; indices, masks "
          f"and keep sets exact) ({smi})", flush=True)
    return n


def phase_detection(torch, mx, counts, smi):
    """Phase 19: the detection slice on the card (see the module
    docstring). Returns the readings PERF.md keeps."""
    import tempfile
    from mxtpu_torch.ops import attention, quant_attention
    ctx = mx.gpu(0)
    counts(0)

    def leg(name, fn, *args):
        t = time.monotonic()
        res = fn(*args)
        torch.cuda.empty_cache()
        print(f"[19 {name}: {time.monotonic() - t:.1f} s]", flush=True)
        return res

    out = {"ssd": leg("(a)", det_ssd_toy, torch, mx, ctx)}
    with tempfile.TemporaryDirectory() as tmp:
        out["image_det_ms"] = leg("(b)", det_image_iter, torch, mx, tmp, ctx)
    out["rcnn"] = leg("(c)", det_rcnn_toy, torch, mx, ctx)
    out["ssd300"] = leg("(d) ssd300", ssd300_layer, torch, mx, smi)
    out["frcnn"] = leg("(d) frcnn", frcnn_legs, torch, mx, smi)
    out["ops"] = leg("(e)", det_ops_card_vs_cpu, torch, smi)
    launches = dict(attention_launches(attention),
                    K5=quant_attention.dequant_decode.launches)
    check(not any(launches.values()),
          f"phase 19 launched a TPU kernel's port: {launches} (the "
          f"detection path runs none of K1-K5)")
    print(f"detection: no TPU kernel lies on this path: K1-K5 launches "
          f"{launches} ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: sparse storage, linalg and the reference's binary format
# ---------------------------------------------------------------------------

# (a): examples/train_sparse_fm.py at tests/test_examples.py:53's
# configuration; the gate is that test's
FM_EXAMPLE = dict(rows=1200, epochs=4, features=5000, rank=8, nnz=20,
                  batch=128, lr=0.5, acc_gate=0.78)
# (b): Criteo's Kaggle click logs in LIBSVM's form (39 fields a row, 13
# integer and 26 categorical, hashed to 1,000,000 features, value 1), at
# the reference FM example's factor size and batch; 20 batches of a file
# written from the seed, the (a) flow's lazy SGD. Each field's value is
# drawn uniformly over the values the field takes: the 26 categorical
# fields over their distinct values in the Kaggle train set as DLRM counts
# them, the 13 integer fields over the 462 values that the Kaggle winners'
# rule (a count v > 2 becomes floor(ln(v)^2)) gives counts below 2^31.
# Uniform draws touch the most rows these cardinalities allow a batch: the
# set's own skew (not published per field) touches fewer. Labels are drawn
# at the train set's click rate and move no measured number.
CRITEO_KAGGLE_CARDINALITY = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
FM_CRITEO = dict(
    features=1_000_000, int_fields=13, int_values=462,
    cat_cardinality=CRITEO_KAGGLE_CARDINALITY, click_rate=0.256, rank=16,
    batch=1000, batches=20, lr=0.5, seed=20,
    source="Criteo Kaggle display-ads train set; categorical cardinalities: "
           "DLRM's Kaggle table sizes (facebookresearch/dlrm); features, "
           "rank and batch: MXNet example/sparse/factorization_machine")
# card against CPU for the FM's w and V: the sums run in another order
# (atomics on the card), so within this share of max(|CPU|, 1)
FM_TOL = 1e-5
# (c): the word LM's net with a row-sparse embedding gradient (WORD_LM's
# widths); step 1 against the dense-gradient net within this share of each
# tensor's largest entry; one step card against CPU: the loss within
# RNN_FWD_TOL, the embedding gradient's values within RNN_STEP_TOL of its
# largest entry
SPARSE_LM_STEP_TOL = 1e-6
# (d): each linalg op at this batched shape, card against CPU (outputs and
# gradients of a sign-invariant loss) within this share of max(|CPU|, 1);
# the five factorizations within LINALG_FACTOR_TOL, about 3x the largest
# share they read on an H100 80GB HBM3 at 700 W (svd 9.0e-5, syevd 4.7e-5,
# eigh 2.8e-5) and well below what cuSOLVER's default Jacobi svd driver
# reads there (1.05e-3; ops/linalg.py asks for gesvd)
LINALG_SHAPE = (4, 64, 64)
LINALG_TOL = 1e-4
LINALG_FACTORIZATIONS = ("qr", "svd", "eigh", "gelqf", "syevd")
LINALG_FACTOR_TOL = 3e-4


def fm_write_example(path, rows, D, nnz, F, seed=0):
    """``examples/train_sparse_fm.py``'s data and initial V (numpy only,
    the example's draws in its order): a planted sparse logistic model
    over D features, rows of ``nnz`` sorted features valued in [0.5,
    1.5). Returns V0 (D, F) float32."""
    import numpy as np
    rs = np.random.RandomState(seed)
    w_true = np.zeros(D, np.float32)
    active = rs.choice(D, D // 10, replace=False)
    w_true[active] = rs.randn(len(active)).astype(np.float32) * 2.0
    with open(path, "w") as f:
        for _ in range(rows):
            idx = np.sort(rs.choice(D, nnz, replace=False))
            val = rs.rand(nnz).astype(np.float32) + 0.5
            label = 1 if float((val * w_true[idx]).sum()) > 0 else 0
            cols = " ".join(f"{i}:{v:.4f}" for i, v in zip(idx, val))
            f.write(f"{label} {cols}\n")
    return (rs.randn(D, F).astype(np.float32) * 0.01)


def fm_write_criteo(path, c):
    """A Criteo-shaped LibSVM file from ``c["seed"]``: each row's fields
    drawn uniformly over their values (``c["int_values"]`` for each integer
    field, ``c["cat_cardinality"]`` for the categorical ones), every
    (field, value) hashed to one of ``c["features"]`` ids, value 1; labels
    at ``c["click_rate"]``. Returns V0 (features, rank) float32 and the
    number of rows."""
    import numpy as np
    rs = np.random.RandomState(c["seed"])
    n, D = c["batch"] * c["batches"], c["features"]
    card = np.array((c["int_values"],) * c["int_fields"]
                    + tuple(c["cat_cardinality"]), np.float64)
    vals = (rs.rand(n, len(card)) * card).astype(np.uint64)
    fields = np.arange(len(card), dtype=np.uint64)
    ids = ((fields * np.uint64(100_000_007) + vals) * np.uint64(2654435761)
           % np.uint64(2 ** 32) % np.uint64(D)).astype(np.int64)
    ids.sort(axis=1)
    label = (rs.rand(n) < c["click_rate"]).astype(np.int64)
    with open(path, "w") as f:
        for y, row in zip(label, ids):
            f.write(f"{y} " + " ".join(f"{i}:1" for i in row) + "\n")
    return rs.randn(D, c["rank"]).astype(np.float32) * 0.01, n


@contextlib.contextmanager
def _section(torch, sections, name):
    """Add the synchronised wall time of the block to ``sections[name]``
    (nothing when ``sections`` is None)."""
    if sections is None:
        yield
        return
    torch.cuda.synchronize()
    t = time.perf_counter()
    yield
    torch.cuda.synchronize()
    sections[name] = sections.get(name, 0.0) + time.perf_counter() - t


def fm_train(torch, mx, it, V0, epochs, lr, ctx, sections=None,
             keep_epochs=True):
    """``examples/train_sparse_fm.py``'s flow on the port, every step on
    ``ctx`` in ``nd`` ops: the ``LibSVMIter`` ``it``'s host batches staged
    to ``ctx``; the FM score from ``sparse.dot(csr, dense)``; the
    row-sparse gradients of w and V from three transposed dots;
    ``kv.push`` into a ``local`` store whose updater is SGD's lazy
    row-sparse update; the updated rows back by ``row_sparse_pull`` into
    the dense w and V. The host reads the accuracy count once an epoch.
    ``sections`` (a dict) takes the synchronised seconds of ``dot``,
    ``dot_t`` (the transposed dots), ``push`` and ``pull``. Returns w, V
    (NDArrays), each epoch's accuracy and seconds (synchronised), the rows
    touched a batch, every touched row (a tensor) and, when
    ``keep_epochs``, (w, V) as numpy after each epoch."""
    from mxtpu_torch import kvstore, nd, optimizer
    from mxtpu_torch.ndarray import sparse
    D, F = it.provide_data[0].shape[1], V0.shape[1]
    w = nd.zeros((D, 1), ctx=ctx)
    V = nd.array(V0, ctx=ctx)
    kv = kvstore.create("local")
    kv.init("w", w)
    kv.init("V", V)
    kv.set_optimizer(optimizer.SGD(learning_rate=lr))
    acc, secs, rows_a_batch, touched, epochs_wv = [], [], [], [], []
    for _ in range(epochs):
        it.reset()
        if ctx.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        correct, seen = nd.zeros((1,), ctx=ctx), 0
        for b in it:
            X = b.data[0].as_in_context(ctx)
            y = b.label[0].as_in_context(ctx)
            n = X.shape[0] - b.pad
            with _section(torch, sections, "dot"):
                xw = sparse.dot(X, w)
                xv = sparse.dot(X, V)
                x2 = sparse.csr_matrix((X.data * X.data, X.indices,
                                        X.indptr), shape=X.shape)
                x2v2 = sparse.dot(x2, V * V)
            score = xw[:, 0] + 0.5 * (xv * xv - x2v2).sum(axis=1)
            prob = 1.0 / (1.0 + nd.exp(-score))
            correct = correct + ((prob > 0.5) == (y > 0.5))[:n].sum()
            seen += n
            delta = (prob - y) / max(n, 1)
            if b.pad:
                delta[n:] = 0.0
            d = delta.reshape((-1, 1))
            with _section(torch, sections, "dot_t"):
                grad_w = sparse.dot(X, d, transpose_a=True)
                grad_v1 = sparse.dot(X, d * xv, transpose_a=True)
                g2 = sparse.dot(x2, d, transpose_a=True)
            rows = g2.indices
            grad_v = sparse.row_sparse_array(
                (grad_v1.data - g2.data * V[rows], grad_v1.indices),
                shape=(D, F))
            with _section(torch, sections, "push"):
                kv.push("w", grad_w)
                kv.push("V", grad_v)
            with _section(torch, sections, "pull"):
                kv.row_sparse_pull("w", out=w, row_ids=rows)
                kv.row_sparse_pull("V", out=V, row_ids=rows)
            rows_a_batch.append(rows.shape[0])
            touched.append(rows.data.long())
        acc.append(float(correct.asscalar()) / max(seen, 1))
        secs.append(time.perf_counter() - t)
        if keep_epochs:
            epochs_wv.append((w.asnumpy(), V.asnumpy()))
    return dict(w=w, V=V, acc=acc, secs=secs, rows=rows_a_batch,
                touched=torch.unique(torch.cat(touched)), epochs=epochs_wv)


def fm_example_leg(torch, mx, tmp, smi):
    """(a) the FM example's flow at its test configuration on the card:
    the accuracy gate, and w and V after epoch 1 against the CPU's."""
    import numpy as np
    from mxtpu_torch.io import LibSVMIter
    c = FM_EXAMPLE
    path = os.path.join(tmp, "fm.libsvm")
    V0 = fm_write_example(path, c["rows"], c["features"], c["nnz"],
                          c["rank"])
    it = LibSVMIter(data_libsvm=path, data_shape=(c["features"],),
                    batch_size=c["batch"])
    card = fm_train(torch, mx, it, V0, c["epochs"], c["lr"], mx.gpu(0))
    cpu = fm_train(torch, mx, it, V0, 1, c["lr"], mx.cpu())
    errs = [float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)
            for a, b in zip(card["epochs"][0], cpu["epochs"][0])]
    acc = card["acc"][-1]
    check(acc > c["acc_gate"],
          f"fm (a): final accuracy {acc:.4f} <= {c['acc_gate']}")
    check(max(errs) <= FM_TOL,
          f"fm (a): w, V after epoch 1 card vs CPU {errs} > {FM_TOL:g} x "
          f"max(|CPU|, 1)")
    per_epoch = len(card["rows"]) // c["epochs"]
    ms = [s * 1e3 / per_epoch for s in card["secs"]]
    print(f"fm (a): examples/train_sparse_fm.py at {c['rows']} rows, "
          f"{c['features']} features, rank {c['rank']}, batch {c['batch']}, "
          f"{c['epochs']} epochs on the card: accuracy by epoch "
          f"{[round(a, 4) for a in card['acc']]} (gate > {c['acc_gate']}); "
          f"w, V after epoch 1 card vs CPU {errs[0]:.3e}, {errs[1]:.3e} of "
          f"max(|CPU|, 1) (tol {FM_TOL:g}); ms a batch by epoch "
          f"{[round(m, 3) for m in ms]}; {np.mean(card['rows']):.1f} rows "
          f"touched a batch ({smi})", flush=True)
    return dict(acc=card["acc"], err=errs, ms=ms)


def fm_criteo_leg(torch, mx, tmp, smi):
    """(b) the FM at Criteo width on the card: parse rate, ms a batch (the
    first pass over the file, one-time costs in its first batch; the whole
    step warm; then each part in a synchronised run), rows touched, peak
    memory; untouched rows keep their initial values bit for bit; w and V
    against the CPU's after the 20 batches."""
    import numpy as np
    from mxtpu_torch.io import LibSVMIter
    c = FM_CRITEO
    path = os.path.join(tmp, "criteo.libsvm")
    t = time.perf_counter()
    V0, n = fm_write_criteo(path, c)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    it = LibSVMIter(data_libsvm=path, data_shape=(c["features"],),
                    batch_size=c["batch"])
    parse_s = time.perf_counter() - t
    nnz = int(it._indptr[-1])
    D, F = c["features"], c["rank"]

    def card_run(sections=None):
        out = fm_train(torch, mx, it, V0, 1, c["lr"], mx.gpu(0),
                       sections=sections, keep_epochs=False)
        return out, out["secs"][0]

    _, cold = card_run()               # warm: cuBLAS, allocator, kernels
    torch.cuda.reset_peak_memory_stats()
    card, wall = card_run()
    peak = torch.cuda.max_memory_allocated()
    sections = {}
    card_run(sections)
    cpu = fm_train(torch, mx, it, V0, 1, c["lr"], mx.cpu(),
                   keep_epochs=False)
    check(len(card["rows"]) == c["batches"],
          f"fm (b): {len(card['rows'])} batches, not {c['batches']}")
    w, Vc = card["w"].data, card["V"].data
    untouched = torch.ones(D, dtype=torch.bool, device=w.device)
    untouched[card["touched"]] = False
    V0_t = torch.from_numpy(V0).to(w.device)
    same_w = bool((w[untouched] == 0).all())
    same_V = torch.equal(Vc[untouched], V0_t[untouched])
    check(same_w and same_V,
          f"fm (b): rows no batch touched moved (w {same_w}, V {same_V})")
    check(torch.equal(card["touched"].cpu(), cpu["touched"]),
          "fm (b): card and CPU touched other rows")
    errs = [rel_err(torch, card["w"].data, cpu["w"].data),
            rel_err(torch, card["V"].data, cpu["V"].data)]
    check(max(errs) <= FM_TOL,
          f"fm (b): w, V after {c['batches']} batches card vs CPU {errs} > "
          f"{FM_TOL:g} x max(|CPU|, 1)")
    nb = c["batches"]
    parts = {k: v * 1e3 / nb for k, v in sections.items()}
    out = dict(gen_s=gen_s, parse_rows_s=n / parse_s, nnz_batch=nnz / nb,
               cold_ms=cold * 1e3 / nb, step_ms=wall * 1e3 / nb,
               parts_ms=parts, rows=float(np.mean(card["rows"])),
               touched=int(card["touched"].numel()), peak_mib=peak / 2**20,
               err=errs)
    print(f"fm (b) Criteo width ({D} features, {c['int_fields']} + "
          f"{len(c['cat_cardinality'])} fields, rank {F}, batch {c['batch']}, {nb} "
          f"batches, {nnz / nb:.0f} non-zeros a batch): file written in "
          f"{gen_s:.2f} s; LibSVMIter parse {n / parse_s:.0f} rows/s; first "
          f"pass {out['cold_ms']:.3f} ms a batch (one-time costs in its "
          f"first batch); {out['step_ms']:.3f} ms a batch (the whole step, "
          f"warm); synchronised "
          f"parts: dot {parts['dot']:.3f}, transposed dots "
          f"{parts['dot_t']:.3f}, push {parts['push']:.3f}, row_sparse_pull "
          f"{parts['pull']:.3f} ms a batch; {out['rows']:.0f} rows touched a "
          f"batch ({out['touched']} in all, untouched rows bit-equal to "
          f"their start); peak memory {out['peak_mib']:.0f} MiB; w, V card "
          f"vs CPU {errs[0]:.3e}, {errs[1]:.3e} of max(|CPU|, 1) (tol "
          f"{FM_TOL:g}) ({smi})", flush=True)
    return out, card


def sparse_lm_net(mx, gluon, ctx, sparse_grad, src=None):
    """``word_lm_net``'s inner block (Embedding -> LSTM -> Dense, TNC) at
    WORD_LM's widths, its embedding's gradient row-sparse when
    ``sparse_grad``; its weights ``src``'s (or Uniform(0.1) from seed
    0)."""
    c = WORD_LM
    V = c["vocab"]

    class LMBlock(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="lm_")
            with self.name_scope():
                self.embedding = gluon.nn.Embedding(V, c["embed"],
                                                    sparse_grad=sparse_grad)
                self.lstm = gluon.rnn.LSTM(
                    c["hidden"], num_layers=c["layers"], layout="TNC",
                    input_size=c["embed"])
                self.decoder = gluon.nn.Dense(V, in_units=c["hidden"],
                                              flatten=False)

        def forward(self, x):
            return self.decoder(self.lstm(self.embedding(x)))

    mx.random.seed(0)
    net = LMBlock()
    net.initialize(mx.init.Uniform(0.1), ctx=ctx)
    if src is not None:
        for p, q in zip(src.collect_params().values(),
                        net.collect_params().values()):
            q.set_data(p.data().as_in_context(ctx))
    return net


def sparse_lm_batches(c, n):
    """``n`` (T, B) token batches (RandomState(i)) and their next tokens,
    flattened T-major, as numpy."""
    import numpy as np
    out = []
    for i in range(n):
        rs = np.random.RandomState(i)
        tok = rs.randint(0, c["vocab"], (c["T"], c["B"])).astype(np.int32)
        out.append((tok, np.roll(tok, -1, axis=0).reshape(-1)
                    .astype(np.float32)))
    return out


def sparse_lm_step(mx, net, trainer, tok, y, ctx):
    """One eager Gluon step: forward under ``record``, softmax
    cross-entropy, backward, ``trainer.step``. Returns the mean loss (a
    float) and the embedding's gradient after the backward."""
    from mxtpu_torch import autograd, gluon, nd
    x, yy = nd.array(tok, ctx=ctx), nd.array(y, ctx=ctx)
    with autograd.record():
        out = net(x)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            out.reshape((-1, WORD_LM["vocab"])), yy)
    loss.backward()
    grad = net.embedding.params.get("weight").grad()
    if trainer is not None:
        trainer.step(tok.size)
    return float(loss.mean().asscalar()), grad


def sparse_lm_leg(torch, mx, smi):
    """(c) the word LM's net with ``Embedding(sparse_grad=True)`` through
    ``gluon.Trainer("sgd", momentum=0.9)``, eager, on the card."""
    import numpy as np
    from mxtpu_torch import gluon
    c = WORD_LM
    gpu = mx.gpu(0)
    batches = sparse_lm_batches(c, 3)
    net = sparse_lm_net(mx, gluon, gpu, True)
    dense = sparse_lm_net(mx, gluon, gpu, False, src=net)
    emb = net.embedding.params.get("weight")
    w0 = emb.data().data.detach().clone()
    opt = {"learning_rate": 1.0, "momentum": 0.9}
    tr = gluon.Trainer(net.collect_params(), "sgd", opt)
    trd = gluon.Trainer(dense.collect_params(), "sgd", opt)
    tok, y = batches[0]
    times = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grad = sparse_lm_step(mx, net, tr, tok, y, gpu)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t)
    uniq = np.unique(tok)
    check(grad.stype == "row_sparse"
          and np.array_equal(grad.indices.asnumpy(), uniq),
          f"sparse LM (c): the table's gradient is {grad.stype} over "
          f"{grad.indices.shape[0] if grad.stype != 'default' else 'all'} "
          f"rows, not row-sparse over the batch's {len(uniq)} ids")
    t = time.perf_counter()
    dloss, _ = sparse_lm_step(mx, dense, trd, tok, y, gpu)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t
    step_err = max(share_err(torch, p.data().data, q.data().data)
                   for p, q in zip(net.collect_params().values(),
                                   dense.collect_params().values()))
    check(step_err <= SPARSE_LM_STEP_TOL and abs(loss - dloss) <= 1e-6 *
          max(abs(dloss), 1.0),
          f"sparse LM (c): step 1 against sparse_grad=False: weights "
          f"{step_err:.3e} of each tensor's largest entry (tol "
          f"{SPARSE_LM_STEP_TOL:g}), losses {loss} vs {dloss}")
    for tok_i, y_i in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        sparse_lm_step(mx, net, tr, tok_i, y_i, gpu)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    seen = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    out_rows = torch.from_numpy(np.setdiff1d(np.arange(c["vocab"]), seen)) \
        .to(w0.device)
    idx = [i for i, p in enumerate(tr._params) if p is emb][0]
    mom = tr._states[idx][0]
    w3 = emb.data().data.detach()
    check(torch.equal(w3[out_rows], w0[out_rows])
          and not bool(mom[out_rows].any()),
          f"sparse LM (c): after 3 steps, rows outside the batches moved or "
          f"hold momentum ({len(out_rows)} rows)")
    cpu = sparse_lm_net(mx, gluon, mx.cpu(), True)
    card1 = sparse_lm_net(mx, gluon, gpu, True, src=cpu)
    lc, gc = sparse_lm_step(mx, card1, None, tok, y, gpu)
    lh, gh = sparse_lm_step(mx, cpu, None, tok, y, mx.cpu())
    gerr = share_err(torch, gc.data.data, gh.data.data)
    lerr = abs(lc - lh) / max(abs(lh), 1.0)
    check(np.array_equal(gc.indices.asnumpy(), gh.indices.asnumpy())
          and gerr <= RNN_STEP_TOL and lerr <= RNN_FWD_TOL,
          f"sparse LM (c): one step card vs CPU: loss {lerr:.3e} (tol "
          f"{RNN_FWD_TOL:g}), gradient ids equal "
          f"{np.array_equal(gc.indices.asnumpy(), gh.indices.asnumpy())}, "
          f"values {gerr:.3e} of the largest entry (tol {RNN_STEP_TOL:g})")
    ms = [s * 1e3 for s in times]
    print(f"sparse LM (c): Embedding({c['vocab']}, {c['embed']}, "
          f"sparse_grad=True) -> LSTM({c['hidden']}, {c['layers']} layers) "
          f"-> Dense({c['vocab']}), f32, T{c['T']} B{c['B']}, SGD momentum "
          f"0.9 through gluon.Trainer, eager: the table's gradient "
          f"row-sparse over the batch's {len(uniq)} ids; step 1 = "
          f"sparse_grad=False within {step_err:.3e} (tol "
          f"{SPARSE_LM_STEP_TOL:g}); after 3 steps {len(out_rows)} rows "
          f"outside the batches bit-equal, momentum 0; ms a step "
          f"{[round(m, 3) for m in ms]} (dense-gradient step 1: "
          f"{dense_s * 1e3:.3f}); one step card vs CPU: loss {lerr:.3e}, "
          f"gradient values {gerr:.3e} ({smi})", flush=True)
    return dict(ms=ms, dense_ms=dense_s * 1e3, rows=len(uniq),
                untouched=len(out_rows), step_err=step_err, gerr=gerr,
                lerr=lerr)


def linalg_inputs(name, shape, seed):
    """Well-conditioned f32 inputs of a linalg op at ``shape`` (B, n, n):
    general matrices I + noise, SPD, Cholesky factors, symmetric with
    spread eigenvalues, and for the factorizations Q1 diag(s) Q2^T with s
    spread over [1, 4]."""
    import numpy as np
    rs = np.random.RandomState(seed)
    B, n, _ = shape

    def general():
        return np.eye(n) + rs.randn(B, n, n) / (2 * np.sqrt(n))

    def spd():
        a = rs.randn(B, n, n)
        return a @ a.transpose(0, 2, 1) / n + np.eye(n)

    def orth():
        return np.linalg.qr(rs.randn(B, n, n))[0]

    def spread(lo, hi):
        return np.linspace(lo, hi, n) * (1 + 0.01 * rs.rand(B, n))

    def factored():
        return np.einsum("bij,bj,bkj->bik", orth(), spread(1, 4), orth())

    def symmetric():
        q = orth()
        return np.einsum("bij,bj,bkj->bik", q, spread(1, n), q)

    make = {
        "gemm": lambda: [general(), general(), general()],
        "gemm2": lambda: [general(), general()],
        "potrf": lambda: [spd()],
        "potri": lambda: [np.linalg.cholesky(spd())],
        "trsm": lambda: [np.linalg.cholesky(spd()), general()],
        "trmm": lambda: [general(), general()],
        "syrk": lambda: [general()],
        "sumlogdiag": lambda: [spd()],
        "extractdiag": lambda: [general()],
        "makediag": lambda: [rs.randn(B, n)],
        "extracttrian": lambda: [general()],
        "maketrian": lambda: [rs.randn(B, n * (n + 1) // 2)],
        "inverse": lambda: [general()],
        "det": lambda: [general()],
        "slogdet": lambda: [general()],
        "svd": lambda: [factored()],
        "eigh": lambda: [symmetric()],
        "qr": lambda: [factored()],
        "gelqf": lambda: [factored()],
        "syevd": lambda: [symmetric()],
    }[name]
    return [a.astype(np.float32) for a in make()]


def linalg_sign_fixed(nd, name, outs):
    """A factorization's outputs with each vector's sign fixed (by R's or
    L's diagonal, or the vector's sum), which makes them and a loss over
    them sign-invariant; other ops' outputs as they are."""
    def ex(x, axis):
        return nd.expand_dims(x, axis=axis)

    if name == "qr":
        q, r = outs
        d = nd.sign(nd.linalg.extractdiag(r))
        return [q * ex(d, -2), r * ex(d, -1)]
    if name == "gelqf":
        q, l = outs
        d = nd.sign(nd.linalg.extractdiag(l))
        return [q * ex(d, -1), l * ex(d, -2)]
    if name == "svd":
        u, s, vt = outs
        d = nd.sign(nd.sum(u, axis=-2))
        return [u * ex(d, -2), s, vt * ex(d, -1)]
    if name == "eigh":
        w, v = outs
        return [w, v * ex(nd.sign(nd.sum(v, axis=-2)), -2)]
    if name == "syevd":
        u, w = outs
        return [u * ex(nd.sign(nd.sum(u, axis=-1)), -1), w]
    return list(outs)


def linalg_run(torch, mx, name, xs, ctx, seed):
    """``nd.linalg.<name>`` on ``ctx`` under ``record``: its (sign-fixed)
    outputs and the gradients of sum(out * c) for its inputs, as CPU
    tensors."""
    import numpy as np
    from mxtpu_torch import autograd, nd
    args = [nd.array(x, ctx=ctx) for x in xs]
    for a in args:
        a.attach_grad()
    with autograd.record():
        out = getattr(nd.linalg, name)(*args)
        outs = linalg_sign_fixed(nd, name, out if isinstance(out, tuple)
                                 else (out,))
    rs = np.random.RandomState(seed)
    cots = [nd.array(rs.uniform(-1, 1, o.shape).astype(np.float32),
                     ctx=ctx) for o in outs]
    autograd.backward(outs, head_grads=cots)
    return ([o.data.detach().cpu() for o in outs],
            [a.grad.data.detach().cpu() for a in args])


def linalg_leg(torch, mx, smi):
    """(d) the 20 linalg ops at LINALG_SHAPE, card against CPU, forward and
    the gradients of a sign-invariant loss; potrf + potri at 1024^2
    timed."""
    import numpy as np
    from mxtpu_torch import nd
    from mxtpu_torch.ops import linalg as ops_linalg  # noqa: F401
    names = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
             "sumlogdiag", "extractdiag", "makediag", "extracttrian",
             "maketrian", "inverse", "det", "slogdet", "svd", "eigh", "qr",
             "gelqf", "syevd"]
    worst, parts = {}, {}
    for i, name in enumerate(names):
        xs = linalg_inputs(name, LINALG_SHAPE, 100 + i)
        co, cg = linalg_run(torch, mx, name, xs, mx.gpu(0), 200 + i)
        ho, hg = linalg_run(torch, mx, name, xs, mx.cpu(), 200 + i)
        errs = [rel_err(torch, a, b) for a, b in zip(co + cg, ho + hg)]
        worst[name] = max(errs)
        parts[name] = ", ".join(f"{e:.2e}" for e in errs)
        tol = LINALG_FACTOR_TOL if name in LINALG_FACTORIZATIONS \
            else LINALG_TOL
        check(worst[name] <= tol,
              f"linalg (d) {name}: card vs CPU outputs and gradients "
              f"{parts[name]} (tol {tol:g} x max(|CPU|, 1))")
    spd = linalg_inputs("potrf", (1, 1024, 1024), 7)[0]
    a = nd.array(spd, ctx=mx.gpu(0))
    chol_ms = timed_ms(torch, lambda: nd.linalg.potrf(a), 10)
    L = nd.linalg.potrf(a)
    inv_ms = timed_ms(torch, lambda: nd.linalg.potri(L), 10)
    inv = nd.linalg.potri(L).data.double().cpu().numpy()[0]
    resid = float(np.abs(inv @ spd[0].astype(np.float64)
                         - np.eye(1024)).max())
    check(resid < 1e-2, f"linalg (d): potri(potrf(A)) A - I at 1024^2 "
          f"{resid:.3e}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    print(f"linalg (d): 20 ops at {LINALG_SHAPE} f32, card vs CPU "
          f"(outputs, then gradients, of a sign-invariant loss; tol "
          f"{LINALG_TOL:g} x max(|CPU|, 1), the factorizations "
          f"{LINALG_FACTOR_TOL:g}): largest "
          f"{'; '.join(f'{k} [{parts[k]}]' for k, _ in top)}; the other "
          f"ops at most {sorted(worst.values())[-5]:.2e}; at 1024^2: potrf "
          f"{chol_ms:.3f} ms, potri {inv_ms:.3f} ms, |potri(potrf(A)) A - "
          f"I| {resid:.2e} ({smi})", flush=True)
    return dict(worst=worst, potrf_ms=chol_ms, potri_ms=inv_ms)


def reference_binary_leg(torch, mx, tmp, smi):
    """(e) ``resnet50_v1``'s parameters through ``nd.save(...,
    fmt="reference")`` into a fresh net on the card: the logits bit-equal;
    a row-sparse and a csr entry of the card through V2."""
    import numpy as np
    from mxtpu_torch import nd
    from mxtpu_torch.gluon.model_zoo import get_model
    from mxtpu_torch.ndarray import sparse
    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = get_model("resnet50_v1")
    net.initialize(mx.init.Xavier(), ctx=gpu)
    g = torch.Generator().manual_seed(20)
    x = torch.randn(4, 3, 224, 224, generator=g).to("cuda")
    with torch.no_grad():
        ref = net(x)
        again = net(x)
    check(torch.equal(ref, again), "reference (e): the source net's two "
          "forwards differ: bit-equality cannot be read")
    path = os.path.join(tmp, "resnet50_v1.params")
    arrays = {k[len(net.prefix):]: p.data()
              for k, p in net.collect_params().items()}
    t = time.perf_counter()
    nd.save(path, arrays, fmt="reference")
    save_s = time.perf_counter() - t
    size = os.path.getsize(path)
    fresh = get_model("resnet50_v1")
    fresh.initialize(ctx=gpu)
    t = time.perf_counter()
    fresh.load_parameters(path, ctx=gpu)
    load_s = time.perf_counter() - t
    with torch.no_grad():
        got = fresh(x)
    check(torch.equal(got, ref), "reference (e): resnet50_v1 loaded from "
          f"the reference format: logits differ by "
          f"{(got - ref).abs().max().item():.3e}")
    rs = np.random.RandomState(2)
    rsp = sparse.row_sparse_array((rs.randn(3, 5).astype(np.float32),
                                   [2, 9, 40]), shape=(64, 5), ctx=gpu)
    dense = rs.randn(6, 7).astype(np.float32)
    dense[rs.rand(6, 7) > 0.3] = 0
    csr = sparse.csr_matrix(dense, ctx=gpu)
    spath = os.path.join(tmp, "sparse.params")
    nd.save(spath, {"rsp": rsp, "csr": csr}, fmt="reference")
    back = nd.load(spath)
    same = (back["rsp"].stype == "row_sparse" and back["csr"].stype == "csr"
            and back["rsp"].context == mx.Context(gpu)
            and np.array_equal(back["rsp"].indices.asnumpy(),
                               rsp.indices.asnumpy())
            and np.array_equal(back["rsp"].data.asnumpy(),
                               rsp.data.asnumpy())
            and all(np.array_equal(getattr(back["csr"], k).asnumpy(),
                                   getattr(csr, k).asnumpy())
                    for k in ("data", "indices", "indptr")))
    check(same, "reference (e): a row-sparse or csr entry changed through "
          "NDARRAY_V2")
    print(f"reference (e): resnet50_v1's {len(arrays)} parameters "
          f"({size / 2**20:.1f} MiB) written as NDARRAY_V2 in {save_s:.2f} "
          f"s, loaded into a fresh net on the card in {load_s:.2f} s: "
          f"logits (B4, 224) bit-equal; a row-sparse and a csr entry of "
          f"the card round-trip, ids and values equal ({smi})", flush=True)
    return dict(mib=size / 2**20, save_s=save_s, load_s=load_s)


def sparse_dot_times(torch, mx, path, V, smi):
    """(f) ``sparse.dot`` and its transposed form at (b)'s shapes (the
    file's first batch, (b)'s trained V) beside ``torch.sparse.mm`` on the
    same operands (a yardstick only, not on the path)."""
    import numpy as np
    from mxtpu_torch import nd
    from mxtpu_torch.io import LibSVMIter
    from mxtpu_torch.ndarray import sparse
    c = FM_CRITEO
    D, F = c["features"], c["rank"]
    it = LibSVMIter(data_libsvm=path, data_shape=(D,), batch_size=c["batch"])
    X = next(iter(it)).data[0].as_in_context(mx.gpu(0))
    G = nd.array(np.random.RandomState(3).randn(c["batch"], F)
                 .astype(np.float32), ctx=mx.gpu(0))
    rows = X._row_ids()
    Xt = torch.sparse_csr_tensor(X._indptr, X._indices, X._values,
                                 size=X.shape)
    XtT = torch.sparse_coo_tensor(torch.stack([X._indices, rows]),
                                  X._values, (D, c["batch"])).coalesce()
    Vt, Gt = V.data, G.data
    ours = timed_ms(torch, lambda: sparse.dot(X, V), 20)
    lib = timed_ms(torch, lambda: torch.sparse.mm(Xt, Vt), 20)
    ours_t = timed_ms(torch, lambda: sparse.dot(X, G, transpose_a=True), 20)
    lib_t = timed_ms(torch, lambda: torch.sparse.mm(XtT, Gt), 20)
    check(rel_err(torch, sparse.dot(X, V).data, torch.sparse.mm(Xt, Vt))
          <= FM_TOL, "dot (f): sparse.dot and torch.sparse.mm disagree")
    nnz = X.nnz
    # each input read once, each output written once: values and columns,
    # the nnz gathered rows of V (G), the output
    b_dot = nnz * (4 + 8) + nnz * F * 4 + c["batch"] * F * 4
    b_dot_t = nnz * (4 + 8) + c["batch"] * F * 4 + nnz * F * 4
    print(f"dot (f) at (b)'s shapes (({c['batch']}, {D}) csr, {nnz} "
          f"non-zeros, "
          f"rank {F}): sparse.dot {ours:.4f} ms, torch.sparse.mm (CSR) "
          f"{lib:.4f} ms, byte bound {b_dot / HBM_BYTES_PER_S * 1e3:.5f} ms; "
          f"transposed (row-sparse out) {ours_t:.4f} ms, torch.sparse.mm "
          f"(COO of X^T, dense (D, F) out) {lib_t:.4f} ms, byte bound "
          f"{b_dot_t / HBM_BYTES_PER_S * 1e3:.5f} ms ({smi})", flush=True)
    return dict(dot_ms=ours, lib_ms=lib, dot_t_ms=ours_t, lib_t_ms=lib_t)


def phase_sparse(torch, mx, counts, smi):
    """Phase 20: sparse storage, linalg and the reference binary on the
    card (see the module docstring). Returns the readings PERF.md
    keeps."""
    import tempfile
    from mxtpu_torch.ops import attention, quant_attention
    counts(0)

    def leg(name, fn, *args):
        t = time.monotonic()
        res = fn(*args)
        torch.cuda.empty_cache()
        print(f"[20 {name}: {time.monotonic() - t:.1f} s]", flush=True)
        return res

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["fm"] = leg("(a)", fm_example_leg, torch, mx, tmp, smi)
        out["criteo"], criteo = leg("(b)", fm_criteo_leg, torch, mx, tmp,
                                    smi)
        out["dot"] = leg("(f)", sparse_dot_times, torch, mx,
                         os.path.join(tmp, "criteo.libsvm"), criteo["V"],
                         smi)
        del criteo
        out["lm"] = leg("(c)", sparse_lm_leg, torch, mx, smi)
        out["linalg"] = leg("(d)", linalg_leg, torch, mx, smi)
        out["reference"] = leg("(e)", reference_binary_leg, torch, mx, tmp,
                               smi)
    launches = dict(attention_launches(attention),
                    K5=quant_attention.dequant_decode.launches)
    check(not any(launches.values()),
          f"phase 20 launched a TPU kernel's port: {launches} (the sparse, "
          f"linalg and reference-format paths run none of K1-K5)")
    print(f"sparse: no TPU kernel lies on this path: K1-K5 launches "
          f"{launches} ({smi})", flush=True)
    return out


def launch_counter(attention, quant_attention):
    """``counts(n)``: every kernel wrapper's launch counts (and the sm90
    route's) set to ``n``."""
    def counts(n):
        for fn in (attention.flash_fwd, attention.flash_bwd_dq,
                   attention.flash_bwd_dkv, attention.flash_bwd_fused,
                   quant_attention.dequant_decode):
            fn.launches = n
        for fn in (attention.flash_fwd, attention.flash_bwd_dq,
                   attention.flash_bwd_dkv, attention.flash_bwd_fused):
            fn.sm90_launches = n
    return counts


def run():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from mxtpu_torch import _build
    except ImportError as e:
        raise SmokeFailure(f"mxtpu_torch not found beside {__file__}: {e}")
    from mxtpu_torch.gluon.model_zoo import transformer as lm
    from mxtpu_torch.ops import attention, quant_attention
    from mxtpu_torch.quant import kv_quant
    from mxtpu_torch import (lr_scheduler, optimizer, parallel, serving,
                             step_cache)
    from mxtpu_torch.gluon import loss as loss_mod
    import mxtpu_torch as mx

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_all = t0 = time.monotonic()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.monotonic() - t0:.1f} s "
          f"(nvcc per kernel: "
          f"{ {k: round(v, 1) for k, v in built.items()} })", flush=True)
    check_build(_build)

    counts = launch_counter(attention, quant_attention)

    def timed_phase(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        print(f"[{name}: {time.monotonic() - t:.1f} s]", flush=True)
        return out

    k1 = timed_phase("K1 checks", phase_k1, torch, attention)
    k5 = timed_phase("K5 checks", phase_k5, torch, quant_attention, kv_quant)
    model, k1_launches = timed_phase("forward", phase_forward, torch, lm,
                                     attention, counts)
    k5_launches, k5_replayed, router_refs = timed_phase(
        "serving", phase_serving, torch, model, serving, quant_attention,
        step_cache, counts)
    timed_phase("profile", phase_profile, torch, model, serving)
    from mxtpu_torch.quant import serve as quant_serve
    timed_phase("int8 products", phase_int8_products, torch, quant_serve,
                smi[0])
    spec_launches, spec_replayed, refs = timed_phase(
        "speculative serving", phase_spec, torch, model, serving,
        quant_attention, step_cache, counts, smi[0])
    k5_slo = timed_phase("SLO control plane", phase_slo, torch, model,
                         serving, quant_attention, step_cache, counts,
                         smi[0], refs)
    k5_router = timed_phase("router", phase_router, torch, model, serving,
                            quant_attention, step_cache, counts, router_refs,
                            smi[0])
    del model
    torch.cuda.empty_cache()
    timed_phase("card vs CPU", phase_card_vs_cpu, torch, lm, serving)
    k5_verify = timed_phase("verify card vs CPU", phase_verify_card_vs_cpu,
                            torch, lm, serving, quant_attention, smi[0])
    timed_phase("serving programs", phase_programs, torch, lm, serving,
                quant_attention, counts)
    bwd = timed_phase("K2/K3/K4 checks", phase_bwd, torch, attention)
    train_launches, train_ms = timed_phase(
        "train", phase_train, torch, lm, attention, optimizer, loss_mod,
        parallel, step_cache, counts)
    torch.cuda.empty_cache()
    timed_phase("train program vs body", phase_train_program, torch, lm,
                attention, optimizer, lr_scheduler, loss_mod, parallel,
                step_cache)
    torch.cuda.empty_cache()
    k4_launches = timed_phase("fused", phase_fused, torch, lm, attention,
                              optimizer, loss_mod, parallel, counts)
    torch.cuda.empty_cache()
    f32_launches = timed_phase("train card vs CPU", phase_train_card_vs_cpu,
                               torch, lm, attention, optimizer, loss_mod,
                               parallel, counts)
    torch.cuda.empty_cache()
    saxpy = timed_phase("K6 checks", phase_k6, torch, mx)
    head = timed_phase("imperative head", phase_head, torch, mx)
    torch.cuda.empty_cache()
    glu, glu_ms = timed_phase("gluon", phase_gluon, torch, mx, lm,
                              attention, parallel, loss_mod, step_cache,
                              counts, smi[0], train_ms)
    torch.cuda.empty_cache()
    mod_l, sym_l = timed_phase("module", phase_module, torch, mx, lm,
                               attention, step_cache, counts, smi[0],
                               train_ms, glu_ms)
    torch.cuda.empty_cache()
    vision_out = timed_phase("vision", phase_vision, torch, mx, counts)
    torch.cuda.empty_cache()
    quant_l = timed_phase("quantization", phase_quant, torch, mx, counts,
                          smi[0], vision_out["score"])
    torch.cuda.empty_cache()
    timed_phase("rnn", phase_rnn, torch, mx, counts, smi[0])
    torch.cuda.empty_cache()
    timed_phase("data", phase_data, torch, mx, counts, smi[0])
    torch.cuda.empty_cache()
    timed_phase("detection", phase_detection, torch, mx, counts, smi[0])
    torch.cuda.empty_cache()
    timed_phase("sparse", phase_sparse, torch, mx, counts, smi[0])
    print(f"K1 launches: forward {k1_launches}, training "
          f"{train_launches['K1']}, gluon {glu['K1']}, module {mod_l['K1']}, "
          f"symbolic graph {sym_l['K1']}, quantized module {quant_l['K1']}",
          flush=True)
    sm90 = {k: train_launches[k] + glu[k] + mod_l[k] + quant_l[k]
            for k in ("K1_sm90", "K2_sm90", "K3_sm90")}
    gl_path = ("train (bf16) + gluon (a) (bf16) + module (a) (bf16) + "
               "quantization (d) (bf16, MXTPU_QUANT_STEP=int8)")

    bwd_src = "mxtpu_torch/csrc/flash_bwd.cu"
    sm90_src = "mxtpu_torch/csrc/flash_bwd_sm90.cu"
    f32_path = "train card vs CPU (f32) + module (c) symbolic graph (f32)"
    # K1 to K4 run on two routes, each on its own path, shape and dtype:
    # one record each
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="mxtpu_torch/csrc/flash_fwd.cu",
             replaces="mxtpu/ops/attention.py:133",
             path="forward (f32) + module (c) symbolic graph (f32)",
             launches=k1_launches + sym_l["K1"], **k1["forward"]),
        dict(name="flash_fwd_sm90", route="cuda",
             source="mxtpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="mxtpu/ops/attention.py:133", path=gl_path,
             launches=sm90["K1_sm90"], **k1["train"]),
        dict(name="flash_bwd_dq_sm90", route="cuda", source=sm90_src,
             replaces="mxtpu/ops/attention.py:182", path=gl_path,
             launches=sm90["K2_sm90"], **bwd["bf16"]["K2"]),
        dict(name="flash_bwd_dq", route="cuda", source=bwd_src,
             replaces="mxtpu/ops/attention.py:182", path=f32_path,
             launches=f32_launches["K2"] + sym_l["K2"], **bwd["f32"]["K2"]),
        dict(name="flash_bwd_dkv_sm90", route="cuda", source=sm90_src,
             replaces="mxtpu/ops/attention.py:220", path=gl_path,
             launches=sm90["K3_sm90"], **bwd["bf16"]["K3"]),
        dict(name="flash_bwd_dkv", route="cuda", source=bwd_src,
             replaces="mxtpu/ops/attention.py:220", path=f32_path,
             launches=f32_launches["K3"] + sym_l["K3"], **bwd["f32"]["K3"]),
        dict(name="flash_bwd_fused_sm90", route="cuda", source=sm90_src,
             replaces="mxtpu/ops/attention.py:262",
             path="train (bf16), MXTPU_FLASH_BWD=fused",
             launches=k4_launches["sm90"], **bwd["bf16"]["K4"]),
        dict(name="flash_bwd_fused", route="cuda", source=bwd_src,
             replaces="mxtpu/ops/attention.py:262",
             path="train (f32, base width, 2 layers), MXTPU_FLASH_BWD=fused",
             launches=k4_launches["simt"], **bwd["f32"]["K4"]),
        dict(name="dequant_decode", route="cuda",
             source="mxtpu_torch/csrc/dequant_decode.cu",
             replaces="mxtpu/ops/quant_attention.py:99", path="serving",
             launches=k5_launches, launches_in_replays=k5_replayed, **k5),
        dict(name="dequant_decode", route="cuda",
             source="mxtpu_torch/csrc/dequant_decode.cu",
             replaces="mxtpu/ops/quant_attention.py:99",
             path="serving, speculative verify (int8_kv,int8_w)",
             launches=spec_launches, launches_in_replays=spec_replayed,
             **k5_verify),
        dict(name="dequant_decode", route="cuda",
             source="mxtpu_torch/csrc/dequant_decode.cu",
             replaces="mxtpu/ops/quant_attention.py:99",
             path="serving, SLO batched prefill", **k5_slo),
        dict(name="dequant_decode", route="cuda",
             source="mxtpu_torch/csrc/dequant_decode.cu",
             replaces="mxtpu/ops/quant_attention.py:99",
             path="serving, router (2 replicas)",
             **{**k5, **k5_router}),
        dict(name="rtc saxpy", route="nvrtc", source="mxtpu_torch/rtc.py",
             kernel_source="chip_smoke.py:SAXPY_SRC",
             replaces="mxtpu/rtc.py:47", path="K6 checks, saxpy at 2^26",
             **saxpy),
    ] + head
    print(f"[chip smoke: {time.monotonic() - t_all:.1f} s]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_module_only():
    """Phase 14 alone, after the build (``python3 chip_smoke.py --phase
    14``): for working on the front ends; no kernels line, no result
    line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch import _build, step_cache
    from mxtpu_torch.gluon.model_zoo import transformer as lm
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.monotonic()
    _build.build_all()
    check_build(_build)
    print(f"[build: {time.monotonic() - t0:.1f} s]", flush=True)
    t0 = time.monotonic()
    phase_module(torch, mx, lm, attention, step_cache,
                 launch_counter(attention, quant_attention), smi[0], None,
                 None)
    print(f"[module: {time.monotonic() - t0:.1f} s] phase 14 passed",
          flush=True)


def run_vision_only():
    """Phase 15 alone (``python3 chip_smoke.py --phase 15``): no kernel of
    the port lies on the vision path, so nothing is built; no kernels
    line, no result line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    phase_vision(torch, mx, launch_counter(attention, quant_attention))
    print(f"[vision: {time.monotonic() - t0:.1f} s] phase 15 passed",
          flush=True)


def run_quant_only():
    """Phase 16 alone, after the build (``python3 chip_smoke.py --phase
    16``): (d) runs its own float fit for the comparison; no kernels line,
    no result line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch import _build
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    _build.build_all()
    check_build(_build)
    print(f"[build: {time.monotonic() - t0:.1f} s]", flush=True)
    t0 = time.monotonic()
    phase_quant(torch, mx, launch_counter(attention, quant_attention),
                smi[0])
    print(f"[quantization: {time.monotonic() - t0:.1f} s] phase 16 passed",
          flush=True)


def run_rnn_only():
    """Phase 17 alone (``python3 chip_smoke.py --phase 17``): no kernel of
    the port lies on the RNN path, so nothing is built; no kernels line,
    no result line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    phase_rnn(torch, mx, launch_counter(attention, quant_attention), smi[0])
    print(f"[rnn: {time.monotonic() - t0:.1f} s] phase 17 passed",
          flush=True)


def run_data_only():
    """Phase 18 alone (``python3 chip_smoke.py --phase 18``): no kernel of
    the port lies on the data path, so nothing is built; no kernels line,
    no result line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    phase_data(torch, mx, launch_counter(attention, quant_attention), smi[0])
    print(f"[data: {time.monotonic() - t0:.1f} s] phase 18 passed",
          flush=True)


def run_detection_only():
    """Phase 19 alone (``python3 chip_smoke.py --phase 19``): no kernel of
    the port lies on the detection path, so nothing is built; no kernels
    line, no result line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    phase_detection(torch, mx, launch_counter(attention, quant_attention),
                    smi[0])
    print(f"[detection: {time.monotonic() - t0:.1f} s] phase 19 passed",
          flush=True)


def run_sparse_only():
    """Phase 20 alone (``python3 chip_smoke.py --phase 20``): no kernel of
    the port lies on the sparse, linalg or reference-format paths, so
    nothing is built; no kernels line, no result line."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxtpu_torch.ops import attention, quant_attention
    import mxtpu_torch as mx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    phase_sparse(torch, mx, launch_counter(attention, quant_attention),
                 smi[0])
    print(f"[sparse: {time.monotonic() - t0:.1f} s] phase 20 passed",
          flush=True)


def main() -> int:
    try:
        if sys.argv[1:] == ["--phase", "14"]:
            run_module_only()
            return 0
        if sys.argv[1:] == ["--phase", "15"]:
            run_vision_only()
            return 0
        if sys.argv[1:] == ["--phase", "16"]:
            run_quant_only()
            return 0
        if sys.argv[1:] == ["--phase", "17"]:
            run_rnn_only()
            return 0
        if sys.argv[1:] == ["--phase", "18"]:
            run_data_only()
            return 0
        if sys.argv[1:] == ["--phase", "19"]:
            run_detection_only()
            return 0
        if sys.argv[1:] == ["--phase", "20"]:
            run_sparse_only()
            return 0
        run()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
