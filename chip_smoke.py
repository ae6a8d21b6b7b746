#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nnstreamer_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the
package beside this file; it imports nothing of JAX or nnstreamer_tpu. It
exits non-zero, printing no result, when any of these is missing or any
phase fails:

1. device — print the card's name and power limit (nvidia-smi);
2. build — build every CUDA kernel from csrc/ (one nvcc each, in
   parallel) and time the build;
3. kernels — hold each kernel against its plain PyTorch version at the
   ``base`` LM's shapes, time kernel, plain version and the PyTorch
   library call that computes the same function, beside the bound;
4. slice end to end — serve 3 requests through
   ``appsrc ! tensor_filter framework=torch model=...lm_serving:base !
   tensor_sink`` (float32, then ``custom=serve_dtype:bfloat16``), check the
   outputs and that every prefill and decode step went through the kernels;
5. streaming — the same 3 requests through ``appsrc ! tensor_generate
   model=...lm_serving:base steps=64 ! tensor_sink`` (float32): one (8, 1)
   int32 buffer per token, the tokens equal to the filter's, every prefill
   and decode step through the kernels; generated tokens/s and the time to
   the first token;
6. teacher-forced parity — prefill and decode_step through the kernels
   and through the dense path on the same tokens; the logits agree after
   the prefill and at every step. Then the
   ``tiny`` entry's greedy tokens on the card equal the CPU path's;
7. conversation — two turns at ``base`` through ``tensor_generate
   conversation=true``, equal to the session API's; turn 2's first-step
   logits (chunked prefill on the kept cache) equal a from-scratch prefill
   over history plus prompt; the same two turns at ``tiny`` give the CPU
   path's tokens;
8. MobileNet-v2 (224×224×3 uint8, width 1.0, 1001 classes) — the
   ``filter_model_u8`` forward at batch 64 in bfloat16 (the card's
   ``auto`` dtype) and float32, timed by CUDA events, with the host's time
   to issue one forward and the forward's device time by aten op
   (torch.profiler); card float32 logits (cuDNN's TF32 flag on) vs the
   CPU's, and bfloat16 vs float32; then three launch lines at batch 64
   (3 warm-up batches, 30 measured), frames/s counted at the sink: the
   host line ``tensor_src ! tensor_aggregator ! queue ! tensor_filter !
   queue ! tensor_sink``, the labeling line (``! tensor_decoder
   mode=image_labeling frames-in=64``) and the device-resident line
   (``tensor_src device=true``). Every frame gets one label, the argmax of
   the logits the filter computed for it, through the decoder's reduce on
   the card; the host frames equal those regenerated from the seed; the
   filter and its outputs are on cuda:0. Each line's host time per batch
   in the filter and the decoder, and the card's busy share over a
   profiled window of each line. Then the p50 latency of one frame
   through ``appsrc ! tensor_filter ! tensor_decoder ! tensor_sink``, and
   the host's per-frame cost of ``tensor_src`` and ``tensor_aggregator``.
   This path runs no hand-written kernel;
9. the raw-media line — ``videotestsrc pattern=gradient ! videoconvert !
   videoscale ! video/x-raw,width=224,height=224,format=RGB !
   tensor_converter frames-per-tensor=64 ! tensor_transform
   mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! queue !
   tensor_filter model=...mobilenet_v2:filter_model ! tensor_decoder
   mode=image_labeling frames-in=64 ! tensor_sink`` (bf16, the card's
   ``auto``), 3 warm-up and 30 measured batches of 64, frames/s counted at
   the sink. The source's frames equal the gradient rebuilt on the host;
   the transform's output on the card equals the port's CPU transform of
   the same frames bit for bit; the transform's and the filter's outputs
   are on cuda:0; one label per frame, the argmax of the filter's logits;
   the logits agree with the ``filter_model_u8`` forward on the same
   frames. A second line sends the transformed batch through
   ``tensor_decoder mode=protobuf ! tensor_converter``: the wire bytes are
   those of the batch's CPU copy, and the converter gives that copy back.
   The host's ms per frame of ``videotestsrc``, the converter's ms per
   batch, the transform's host ms (its H2D copy and launches) and device
   ms (CUDA events) per batch, and the card's busy share over a profiled
   window. This path runs no hand-written kernel either.

10. continuous-batching LM serving at ``base`` width — (a) the decode
    kernel with one position per slot, pos = 0, 17, 130, 543, 1023, 1500,
    2000, 2047 over 8 slots, f32 and bf16 caches, held against its plain
    version (phase 3's tolerances) and timed beside its bound and SDPA
    with a per-row boolean mask; (b) ``base.make_continuous(slots=8)``
    behind ``DecodeScheduler``: 24 requests (prompts of 64-512 tokens
    from seed 0, 64 steps) in three waves of 8, each submitted when the
    previous one is half done; every request's tokens equal the same
    prompt run alone through the batch-1 ``make_generate`` on the card
    (a mismatch passes only where the batch-1 run's top-2 logit margin at
    the first differing step is below 1e-4; later steps of that request
    are then not compared), 12 decode-kernel launches per decode step and
    12 flash launches per admit; tokens/s, time to first token, step
    time, mean active slots; (c) the paged engine (page 16, chunk 64,
    prefix sharing) on the same 24 requests plus 8 that share a
    256-token prefix: tokens equal the dense engine's (the same near-tie
    rule), pages shared while they run, and one slot's preempt→restore
    byte-exact; (d) the paged engine behind an n-gram draft (k=4): tokens
    equal target-only decoding, the acceptance rate; (e) two pipelines
    ``appsrc ! tensor_serving framework=torch
    model=...mobilenet_v2:filter_model_u8 shared-key=mnet
    bucket-sizes=1,2,4,8 ! tensor_sink``, 32 frames each fed in
    lockstep: every frame's label equals the argmax ``tensor_filter``
    gives for it, and at least one batch mixed both streams.

11. the zoo — the three lines of the reference's bench suite
    (tools/bench_suite.py:637-682) at 224×224×3, bf16 on the card:
    ``tensor_src ! tensor_aggregator frames-out=64 ! queue ! tensor_filter
    model=...<m>:filter_model_u8 ! queue ! tensor_decoder <dec>
    frames-in=64 ! tensor_sink`` with SSD-MobileNet (91 classes, 3135
    anchors) into ``mode=bounding_boxes option1=mobilenet-ssd-postprocess
    option3=,30 option4=224:224``, PoseNet (17 keypoints, 28×28 heatmaps)
    into ``mode=pose_estimation option1=224:224 option2=heatmap``, and
    DeepLab (21 classes, logits upsampled to 224×224) into
    ``mode=image_segment option1=tflite-deeplab``. For each model: card
    float32 (cuDNN's TF32 flag on) vs the CPU's and bf16 vs float32 on
    every output (phase 8's limits; SSD's scores 2e-3 in bf16), the bf16
    forward's time at batch 64; the line at 3 warm-up and 30 measured
    batches of 64, frames/s at the sink, the filter's and the decoder's
    host ms a batch, the bytes that cross to the host a batch with and
    without the decoder's reduce; every batch reduced on the card (no
    host decode) and every output on cuda:0. Gates: two batches of the
    filter's card outputs decoded per frame on the host (frames-in=1,
    pulled first) equal the batched reduce on the card — the line's own
    decoded bytes for image_segment and pose_estimation, the (box,
    class) lists and overlay bytes at ``option10=4096`` (no candidate
    cut) for bounding_boxes, whose candidates above the threshold and
    kept at the line's cap of 256 are printed. Then the push-to-decoded
    p50 of one frame through ``appsrc ! tensor_filter ! tensor_decoder
    ! tensor_sink``. This path runs no hand-written kernel.

12. the observability plane — (a) phase 4's float32 filter line at
    ``base`` (3 requests) with every hook on: the tracers ``proctime;
    framerate;interlatency;queuelevel;chrometrace``, the profiler, the
    quality taps on every buffer, the memory accountant and request
    tracing; request 3 inside ``trace.torch_trace`` (its trace in a
    temporary directory, deleted after it is read). Gates: the tokens
    equal phase 4's; the launch counters read phase 4's counts; the trace
    holds as many device events of each hand kernel as request 3 launched;
    CUPTI loses kernel records in many traces on the H100, so a trace in
    which ``torch_trace`` counts lost records and a hand kernel falls short
    is not judged: the line runs again, up to OBS_TRACE_ATTEMPTS times, and
    fails if no trace holds every launch (a short trace with no lost
    record, or more events than launches, fails at once);
    every element has a proctime row and a profiler series counting its
    buffers; the chrome trace (chiprun_out/obs/) loads with one span per
    element and buffer; every edge has a health cell without NaN or Inf;
    the accountant's filter stage holds ``tree_nbytes`` of the model's
    parameters; ``sample_devices`` reports cuda:0's total memory and live
    bytes no smaller than the parameters. Each kernel's median device ms
    in the trace is printed beside phase 3's. (b) phase 10e's two
    ``tensor_serving`` pipelines (bf16 MobileNet, shared scheduler) with
    the taps on every buffer and NNS_XFERCHECK's ledger on: the
    ``serving:<name>`` series sampled every batch, each card reduce equal
    to the host reduce of the same output pulled afterwards (counts and
    histogram exact, moments within the CPU tests' float32 tolerance),
    at most 1 KiB pulled a sample, the profiler's request series counting
    every request. (c) ``tensor_src ! tensor_aggregator frames-out=64 !
    queue ! tensor_filter model=...mobilenet_v2:filter_model_u8 !
    tensor_fault nan-at-buffer=2 ! tensor_sink`` (bf16) with the taps on:
    one ``quality`` flight event, at the sink's edge, from batch 2;
    ``worst_score()`` is NONFINITE_SCORE; batches 0-1 carry no NaN. (d)
    the LM line's tokens/s and the MobileNet host line's frames/s with
    ``Pad.push``'s trace check removed, as shipped with every hook off,
    and with every hook on (taps every 8th buffer), each state twice
    (no limit; the LM line serves phase 4's requests three times a run).

13. fusion and placement (ROADMAP A4) — (a) ``tensor_src device=true
    dimensions=16 types=float32 ! `` 1 and 8 × ``tensor_transform
    mode=arithmetic option=add:1 ! tensor_sink``, fused (one CUDA graph
    replay a buffer) and with ``fuse=False``, 2000 buffers a run: host µs
    a buffer and an element, the marginal element, dispatches and
    captures; the 8-element chain's sink bytes equal in both modes. (b)
    ``tensor_src device=true pattern=random types=uint8
    dimensions=3:224:224:64 ! tensor_transform mode=arithmetic
    option=typecast:float32,add:-127.5,div:127.5 ! tensor_filter
    model=...mobilenet_v2:filter_model ! queue ! tensor_sink`` (bf16, 3
    warm-up and 30 measured batches), fused (one segment, transform ..
    filter) and unfused: frames/s at the sink, host ms to issue a batch,
    the card's busy share over a profiled window, and the batch-1 p50 of
    ``appsrc ! tensor_transform ! tensor_filter ! tensor_sink``. Gates:
    logits bit-equal fused vs unfused, one capture and 33 dispatches,
    outputs on cuda:0, every stored sink buffer intact after the run.
    (c) ``place="auto"`` with a ProfileStore in a temporary directory on
    ``tensor_src ! tensor_aggregator frames-out=64 ! tensor_transform !
    tensor_filter ! queue ! tensor_sink``: the plan names cuda:0, host
    batches ride the pinned stager, the calibration window opens at
    play() and closes after 48 dispatches with an artifact saved, the
    queue's tuned depth lies in [2, 64], a second run plans from the
    artifact without calibrating, and its sink bytes equal
    ``place=False``'s. (d) A fused segment's host→device path: the
    pinned stager the port uses against the plain path (a blocking
    pageable ``.to(card)`` of each host frame, patched in here), in the
    order stager, plain, plain, stager, on (c)'s host line, on ``appsrc
    ! tensor_transform ! tensor_filter ! queue ! tensor_sink`` fed
    batches of 64 host frames back to back, and on (b)'s batch-1 p50
    line: frames/s at the sink, the segment's host ms a dispatch, p50.
    Gates: the sink's logits are bit-equal on the two paths; every batch
    of a stager run is staged, none of a plain run. This phase runs no
    hand-written kernel.

14. streams (ROADMAP A5, first half) — SingleShot, the filter's hot
    swap and suspend, and the stream-structure elements, MobileNet-v2
    and PoseNet at batch 64 (bf16, the card's ``auto``). (a) bench.py's
    flow: ``SingleShot("torch", ...mobilenet_v2:filter_model_u8,
    share_key="bench")`` on cuda:0 warmed at (64, 224, 224, 3) uint8,
    frames/s of 8 direct invokes at batch 64, 128 and 256 and the
    winner; then ``tensor_src ! tensor_aggregator frames-out=64 ! queue !
    tensor_filter shared-tensor-filter-key=bench ! queue ! tensor_sink``
    (3 warm-up, 30 measured batches) and its frames/s; the batch-1
    invoke p50. Gates: one backend instance, opened once, for both; a
    batch made again from the seed gives single.invoke logits bit-equal
    to the line's; outputs on cuda:0; a wrong shape and a wrong dtype
    refused before dispatch; ``builtin://sleeper?ms=200`` with
    ``timeout_ms=50`` raises TimeoutError and the next invoke returns its
    own result. (b) ``tensor_src device=true ... num-buffers=33 !
    tensor_if compared-value=a-value operator=lt supplied-value=64 !
    tee`` into MobileNet and PoseNet filters, ``tensor_mux !
    tensor_demux tensorpick=0,1``, labels and pose at two sinks (the
    source draws [0, 127), so about half the batches pass): the passed
    set equals the host decision on the regenerated frames, outputs
    bit-equal to each filter alone, every tensor from source to decoder
    on cuda:0, labels = argmax; frames/s at each sink and the card's
    busy share; a short run with ``tensor-average-value gt 60`` (all
    pass) whose float32 reduce on the card is within 1e-6 of the host's
    float64 mean. (c) a tee into both pads of ``tensor_merge option=0 !
    tensor_split axis=0 tensorseg=64,64``: the merged (128, 224, 224, 3)
    tensor on cuda:0 equals ``torch.cat`` of the parts, both halves equal
    the input. (d) phase 13b's fused line with ``reload_model`` to
    ``...mobilenet_v2:filter_model_seed1`` at batch 12's boundary: 33
    batches out, each bit-equal to exactly one model's fused run alone,
    one switch at batch 12, 2 captures, the filter's swap log "segment
    fence" then "released", ``is-updatable=false`` refusing with the
    reference's texts; then ``suspend=200`` on the fused appsrc form of
    the line: after 0.5 s idle the backend is closed and
    ``memory_allocated`` fell by at least the weights' bytes, and the
    next batch's logits are bit-equal to the same batch's before. Prints
    the time from ``reload_model`` to the first new-model batch and the
    reopen time. This phase runs no hand-written kernel.

15. plugins (ROADMAP A5b) — the python, custom-easy and custom C filter
    backends, the python3 converter and decoder, the mixer and datarepo,
    at batch 64 (bf16, the card's ``auto``), 2 warm-up and 8 measured
    batches a line. (a) upstream NNStreamer's object-detection overlay:
    ``videotestsrc pattern=gradient ! videoconvert ! videoscale !
    video/x-raw,width=224,height=224,format=RGB ! tee name=t``, one branch
    ``queue ! tensor_converter frames-per-tensor=64 ! tensor_filter
    model=...ssd_mobilenet:filter_model_u8 ! tensor_decoder
    mode=bounding_boxes ... frames-in=64 ! tee`` into ``mix.sink_1`` and a
    second sink, the other ``queue max-size-buffers=128 ! mix.sink_0``,
    ``compositor name=mix ! tensor_sink``. Gates: one mixed frame per
    source frame, pts rising; each equals a plain numpy blend of the
    gradient frame rebuilt on the host and the overlay captured after the
    decoder; the filter's outputs on cuda:0; 16 of those (frame, overlay)
    pairs through ``appsrc ! videomixer`` and ``appsrc ! compositor`` give
    the same bytes. Frames/s at the mixer's sink, the mixer's host ms a
    frame, the decoder's host ms a batch, the card's busy share over a
    profiled window. (b) MobileNet-v2 ``filter_model_u8`` on cuda:0
    registered as custom-easy ``mnet``: ``tensor_src device=true ... !
    tensor_filter framework=custom-easy model=mnet ! tensor_decoder
    mode=image_labeling frames-in=64 ! tensor_sink``. Gates: logits on
    cuda:0 and bit-equal to a direct call on the regenerated frames,
    labels their argmax; frames/s. (c) (b)'s frames as octet batches
    through ``tensor_converter mode=custom-script:`` (a reference-style
    ``CustomConverter``), MobileNet-v2 on the card, ``tensor_filter
    framework=python`` (numpy softmax, top-1) and ``tensor_decoder
    mode=python3`` (a reference-style ``CustomDecoder`` writing the labels
    as int32 bytes). Gates: labels equal (b)'s; every python stage handed
    host arrays; the logits pulled to the host once a batch. Each python
    stage's host ms a batch. (d) an inline reference-style C++ plugin
    (per-row argmax of the float32 logits, and with ``custom=max:bf16``
    each row's maximum as a bfloat16 output), built with g++ against
    ``nnstreamer_tpu_torch/native/csrc`` into build/plugins, after
    MobileNet-v2 on ``tensor_src device=true``. Gates: argmax equal to
    ``torch.argmax`` and to (b)'s labels; the maximum equal to
    ``max().to(torch.bfloat16)``; host ms a batch. (e) datareposink writes
    8 batches of (b)'s logits in bf16 and f32, datareposrc reads them back
    byte-exact; then datareposrc (2 epochs of 8 batches of (b)'s frames)
    feeds MobileNet-v2 on the card, labels equal (b)'s, frames/s. (f)
    queue C on the card: the crop and sparse lines on ``tensor_src
    device=true types=bfloat16`` give the CPU run's bytes, and a random
    bf16 card stream survives the sparse round trip. No fallback: a
    failed build, load or gate fails the run. tensor_src_iio has no
    phase: the card's machine has no IIO device. This phase runs no
    hand-written kernel.
16. ``.tflite`` models (also ``--only tflite``): the committed full-width
    int8 MobileNet-v2 fixture (``tests/fixtures/
    mobilenet_v2_1.0_224_int8.tflite``) at batch 64, 2 warm-up and 8
    measured batches. (a) g++ builds the native host runtime and the q8
    engine from the checkout; both must load. (b) ``tensor_src
    device=true types=int8 ! tensor_filter framework=torch
    model=<fixture> custom=quantized_exec:<mode>,batch:64 !
    tensor_decoder mode=image_labeling`` runs fake-quant, float and int8
    on cuda:0, the host line (``tensor_src ! tensor_aggregator ! queue !
    tensor_filter``) int8-native. Gates: int8 on the card equals
    int8-native's bytes on every frame of both lines; fake-quant and
    float within 2 LSB of the port's CPU run on 4 frames; every label its
    frame's argmax; the tiny fixture the CPU run's bytes in all four
    modes; the TF32 switches the same after the phase. Frames/s, forward
    ms (CUDA events), the card's busy share, int8-native's host ms a
    batch. (c) a uint8 → int8 ``tensor_transform`` before the int8
    filter, fused and not: one capture, equal sink bytes; host ms to issue
    a batch. (d) ``framework=tflite`` and ``framework=auto`` on the
    fixture post a bus ERROR naming tensorflow (the machine has none;
    nothing reaches the sink). (e) ``datareposrc`` (shuffled, 2 epochs)
    feeds the int8 filter with ``use-native`` true and false: the same
    samples in the same order, the same outputs; frames/s. fake-quant's
    convs and FULLY_CONNECTED at the shapes of ``FMA_ORDERS``, and its
    MEAN at those of ``MEAN_FMA_SHAPES`` (``mean_fma``), run
    ``csrc/fma_gemm.cu`` (the reference's XLA:CPU summation order: one,
    two or four chains, or one chain a block of K): it must launch once a
    listed op a forward, and equal its plain version bit for bit at every
    shape and order of a forward, on the line's own operands, and give the
    same bits on those operands as a strided view (times, the tile the
    kernel picked and the ratios for each shape and a forward beside the
    bound and ``torch.matmul``'s). The card's batch-64 fake-quant output
    on the host line's first batch equals the jitted reference's,
    committed as ``tests/fixtures/
    mobilenet_v2_1.0_224_int8_fake_quant_b64.npz`` (0 LSB, the distance
    of the port's CPU run, ROADMAP §C).
    fake-quant's depthwise convs at the shapes of
    ``DEPTHWISE_FMA_SHAPES`` run ``csrc/depthwise_fma.cu`` (XLA:CPU's
    contracted order): it must launch once a listed op a forward, and
    equal its plain version bit for bit at every shape of a forward, on
    the line's own operands (times beside the bytes bound and a grouped
    ``F.conv2d``'s).
17. transport and query (also ``--only query``, after phase 4's local
    line). (a) ``tensor_query_serversrc ! tensor_filter framework=torch
    model=...lm_serving:base ! tensor_query_serversink`` in a process of
    its own (``sys.executable``, importing only the package) serves phase
    4's 3 requests from ``appsrc ! tensor_query_client ! tensor_sink``.
    Gates: the tokens equal phase 4's; the server process counts 2268
    decode and 36 flash launches and pulls each answer from the card once;
    the handshake selected NNSB with the shm ring (3 shm frames each way
    in ``nns_wire_frames_total``). Generated tokens/s and each request's
    round trip against phase 4's local request. (b) MobileNet-v2
    ``filter_model_u8`` (bf16) behind an in-process query server: the same
    2 + 8 batches of 64 from ``appsrc ! tensor_query_client ! tensor_sink``
    lines with ``wire=json``, ``shm=false`` and the defaults (NNSB with
    shm, the rings' slots sized from the caps and the first answer).
    Gates: the negotiated plane; ``nns_wire_frames_total`` of that plane
    rose by 2 a batch each way (sender and receiver share the process),
    of the others by 0, and no frame overflowed a slot; every answer
    byte-equal to the server's own forward on the same frames. Frames/s, round-trip p50, wire bytes a batch each way, host ms
    to encode and decode a batch. (c) ``attach_scheduler``: 8 clients,
    released by a barrier, send batch-1 frames; gates: logits equal the
    rows of a batch-8 forward, fewer scheduler batches than requests.
    (d) ``tensor_shard`` across two server processes on the card, then
    ``tensor_unshard``: labels and order equal the unsharded line's. (e)
    one bf16 logits batch from the card through edgesink → edgesrc, a
    HYBRID query link discovered over the embedded MiniBroker, and
    mqttsink → mqttsrc: bytes equal; ``tensor_sink_grpc`` posts a bus
    ERROR naming grpc where grpc is absent (else the bytes equal through
    ``tensor_src_grpc``).

18. the service plane (also ``--only service``, after phase 4's local
    line). (a) ``python -m nnstreamer_tpu_torch serve cfg.json`` in a
    process of its own: slot ``lm`` → ``lm_serving:base``, restart
    ``always``, the service ``tensor_query_serversrc ! tensor_fault !
    tensor_filter model=registry://lm ! tensor_query_serversink``; its
    READY state read through ``ControlClient``; phase 4's 3 requests from
    ``appsrc ! tensor_query_client ! tensor_sink``. Gates: tokens equal
    phase 4's; the serve process counts 2268 decode and 36 flash launches
    (``nns_kernel_launches_total`` at its ``/metrics``);
    ``nns_service_up{service="lm"}`` is 1. (b) tensor_fault crashes the
    service on each run's 4th request, 3 times. Gates: a crash report
    naming the fault; the pipeline replayed no sooner than the policy's
    backoff; READY again with the next answer; the next requests' tokens
    equal phase 4's; the card bytes of the served model (after each run's
    requests) within 64 MiB of the first run's. Crash to replay and to
    READY. (c) MobileNet-v2 ``filter_model_u8`` (bf16, batch 64) in an
    in-process query-server service on slot ``mnet`` (seed-0 and seed-1
    weights), one fused transform → filter segment; a client line
    streams 8 batches, then on while ``swap("mnet", "2")`` flips in a
    thread of its own until it has finished, then 8 more. Gates: no
    failed request; every answer v1's or v2's forward byte for byte, v1
    first, then v2 alone, in all of the last 8; the old backend released
    after a segment or stream fence, and the card's allocated bytes after
    the last 8 within half the model's parameter bytes of those before
    the swap (a kept v1 would add all of them). Then ``canary(..., 0.25)`` over 40 batches: each batch
    answered by the version the router's rule gives (10 / 30), the
    segment defused for the window and re-fused after
    ``promote_canary``. Swap time and the longest gap across the flip.
    (d) a ``ProcReplicaSet`` of 2 MobileNet-v2 replicas on the card
    (READY lines report ``cuda:0``): 20 batches through the pool, one
    replica SIGKILLed mid-stream; gates: reap → evict → respawn →
    readmit with zero client-visible errors, every answer equal to the
    in-process forward; an ``Autoscaler`` burst scales out to 3 and idle
    scales back in to 2; ``FleetView``'s merged request count equals the
    replicas' own. Frames/s with 2 replicas and 1, round-trip p50,
    SIGKILL → readmit, scale-out time. (e) a caps mismatch and an
    unknown element refused with ``AdmissionRejected`` (NNL003, NNL001).

19. training, MoE and the parallel layer (also ``--only train``), float32
    with TF32 off, the ``base`` LM's width. (a) five SGD steps (lr 1e-2)
    of ``models/transformer.py::make_train_step`` on a seeded (8, 513)
    batch; gates: the losses finite and falling; step 0's loss within a
    relative 1e-5 of a float64 step on the card from the same weights,
    its whole gradient (every leaf as one vector) within a relative L2
    error of 1e-2 and each leaf within 5e-2 (TR_*_RTOL; read at 1.36e-3
    whole and 1.84e-3 the worst leaf, block 0's, at this width). Step ms
    (CUDA events), tokens/s, peak bytes. (b) the same with
    ``moe_experts=8`` (the float64 step replays the float32 step's
    routing, counting the decisions its own argmax would take otherwise);
    the aux term and the tokens dropped over capacity a layer. (c)
    ``appsrc ! tensor_filter model=...lm_serving:base_moe ! tensor_sink``,
    3 requests of (8, 128), 64 steps; gates: 2268 decode and 36 flash
    launches; every token the dense path's argmax on the same prefix and
    routing (recorded from the filter's run), but at a near tie (top-2
    margin below 1e-4). (d) ``appsrc ! tensor_trainer framework=optax
    model-config=nnstreamer_tpu_torch/models/lm_train.py
    custom=batch:8,optimizer:adamw,ckpt_dir:...`` with 32 training and 8
    validation samples an epoch: 2 epochs, then a resume to 4; gates:
    the history kept, the resumed losses and final validation loss within
    a relative 1e-3 of an uninterrupted 4-epoch run, the parameters on the
    card. (e) a world-1 NCCL group: one meshed step with ``attn_impl``
    ring, ulysses and gspmd, each within the gates of (a) of the meshless
    step: 1e-5 on the loss, 1e-2 on the whole update and 5e-2 on each
    leaf's (relative L2; read at 1.14e-3 whole and 1.26e-2 the worst
    leaf, the ring's); a 1-stage GPipe of block 0's MLP, outputs and
    gradients equal to the plain stage's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
``python3 chip_smoke.py --only fusion`` (``--only streams``, ``--only
plugins``, ``--only tflite``, ``--only query``, ``--only service``,
``--only train``) runs phase 13 (14, 15, 16, 17, 18, 19) alone and prints its report as the last
line (no kernel line, no ``ok`` line). ``--only trace-loss`` is no phase
of the full run: it builds the kernels, serves phase 4's requests, then
takes OBS_LOSS_TRACES traces of phase 12's LM line and counts those in
which CUPTI lost kernel records, those short of a hand-kernel launch and
those without any kernel record.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, float32
# (non-tensor-core) flop/s, dense bfloat16 and TF32 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# the flash kernel runs an f32 product as three TF32 products (3xTF32)
F32_FLASH_FLOP_PER_S = TF32_FLOP_PER_S / 3

# kernel vs plain version: both accumulate in float32 (a bfloat16 cache is
# widened exactly), so they differ only in summation order
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
# a bfloat16 flash output is the kernel's float32 result rounded once, so it
# is held against the plain version's float32 result on the same inputs
# with half a bf16 step (at most 2^-8 relative) added to rtol
BF16_HALF_STEP = 2.0 ** -8
# teacher-forced logits, kernel vs dense path, 12 layers deep: f32 differs by
# summation order only; with a bf16 cache one K/V value rounded the other
# way shifts a logit by about a bf16 ulp of its inputs
PARITY_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

BASE_SHAPE = dict(B=8, H=16, T=2048, D=64, block_k=128)
# plus each side of the decode kernel's split boundaries (split_boundaries)
CHECK_POS = (0, 127, 128, 1023, 2047)
PROMPT, REQUESTS, STEPS = 512, 3, 64
# the prefill's attention on the main path: (B, H, S, D), causal
FLASH_SHAPE = (8, 16, PROMPT, 64)
# conversation phase: tokens per turn; turn 2's prompt length (turn 1's
# is PROMPT)
TURN_STEPS, TURN2_PROMPT = 16, 64
# chunked-prefill logits vs a from-scratch prefill, 12 layers, float32
CONV_ATOL = 1e-4
# the decode steps of the main path attend at positions PROMPT..PROMPT+62;
# the kernel line is timed at the middle one
MAIN_POS = PROMPT + (STEPS - 1) // 2

# MobileNet-v2 phase: batch, warm-up and measured batches (bench.py:30-32),
# frames for the batch-1 latency, frames for the parity checks
MB_MODEL = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8"
MB_BATCH, MB_WARM, MB_MEASURED = 64, 3, 30
MB_P50_WARM, MB_P50_FRAMES = 10, 50
# batches in the profiled window of each line (after MB_WARM warm-up ones)
MB_PROFILED = 8
MB_PARITY_FRAMES = 8
# card f32 vs CPU f32 (summation order only, no TF32): max |logit err|,
# and the centred logits' error as a share of their std (random weights
# make the logits almost input-independent, so the max alone would pass a
# model that ignored its input); bf16 vs f32, about twice nnstreamer_tpu's
# own bf16-vs-f32 gap of 2.28e-4 on its CPU
MB_LOGIT_ATOL, MB_CENTRED_SHARE, MB_BF16_ATOL = 1e-5, 0.01, 5e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, args_list, reps: int = 9, inner: int = 20,
            sleep_cycles: int = 20_000_000) -> float:
    """Median per-call device time in ms over ``reps`` runs of ``inner``
    calls, cycling through ``args_list`` (distinct buffers, so the 50 MB L2
    holds none of them from the previous call, as in the decode loop where
    each layer reads its own cache). A device-side sleep queued ahead of
    each run lets the host enqueue all ``inner`` calls before the first
    starts, so the events time the card, not the Python wrapper."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)   # 20M cycles: ~10 ms
        start.record()
        for i in range(inner):
            fn(*args_list[i % len(args_list)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def decode_bound_ms(B, H, D, pos, elt) -> tuple:
    """Least time for one decode attention: each valid key and value row,
    q and the output moved once; 4 flops per key element plus the exps."""
    n = pos + 1
    nbytes = 2 * B * H * n * D * elt + 2 * B * H * D * 4 + 4
    flops = 4 * B * H * n * D + B * H * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def split_boundaries(rows: int, t_len: int, dev: torch.device) -> tuple:
    """Positions on each side of the decode kernel's split boundaries: pos
    + 1 = n_split * 16 * j fills every split exactly (j = 1 and the main
    path's prompt end), one less leaves the last split one short, one
    more grows the share."""
    from nnstreamer_tpu_torch.ops.decode_attention import (
        SHARE_ALIGN,
        decode_splits,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = decode_splits(rows, t_len, sms)
    out = []
    for full in (n * SHARE_ALIGN, PROMPT):
        full = full // (n * SHARE_ALIGN) * n * SHARE_ALIGN
        out += [p for p in (full - 2, full - 1, full) if 0 <= p < t_len]
    return tuple(sorted(set(out)))


def flash_bound_ms(B, H, S, D, elt) -> tuple:
    """Least time for one causal flash attention: q, k, v read and the
    output written once; 4D flops (q.k and p.v) and one exp per visible
    (q, k) pair, at the card's rate for the kernel's products: bf16 on the
    tensor cores, f32 as three TF32 products each (a third of the TF32
    rate)."""
    pairs = S * (S + 1) // 2
    nbytes = 4 * B * H * S * D * elt
    flops = B * H * pairs * (4 * D + 1)
    rate = F32_FLASH_FLOP_PER_S if elt == 4 else BF16_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build(report: dict) -> None:
    from nnstreamer_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_kernels()
    report["build_s"] = time.perf_counter() - t0
    report["build_logs"] = build.build_logs
    print(f"build: {sorted(libs)} in {report['build_s']:.3f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernels(report: dict, dev: torch.device) -> dict:
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    s = BASE_SHAPE
    B, H, T, D, bk = s["B"], s["H"], s["T"], s["D"], s["block_k"]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, 1, D, device=dev, generator=gen)
    sweep = []
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = torch.tensor([], dtype=dtype).element_size()
        # enough distinct caches that one pass over them overflows the L2
        n_copies = 4 if dtype is torch.float32 else 6
        caches = [(torch.randn(B, H, T, D, device=dev, generator=gen).to(dtype),
                   torch.randn(B, H, T, D, device=dev, generator=gen).to(dtype))
                  for _ in range(n_copies)]
        k, v = caches[0]
        for pos in sorted(set(CHECK_POS) | set(split_boundaries(B * H, T, dev))):
            got = decode_attention(q, k, v, pos, bk)
            want = decode_attention_plain(q, k, v, pos, bk)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
            sweep.append({"dtype": str(dtype), "pos": pos, "max_abs_err": err})
        pos = MAIN_POS
        pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
        args = [(q, ck, cv, pos_t, bk) for ck, cv in caches]
        # SDPA takes one dtype for q, k and v: with a bf16 cache it gets a
        # bf16 q (and returns bf16), while the kernel takes the f32 q
        q_lib = q.to(dtype)
        lib_args = [(q_lib, ck[:, :, :pos + 1], cv[:, :, :pos + 1])
                    for ck, cv in caches]
        err = (decode_attention(q, k, v, pos_t, bk)
               - decode_attention_plain(q, k, v, pos_t, bk)).abs().max().item()
        bound, bound_by = decode_bound_ms(B, H, D, pos, elt)
        ms = time_ms(decode_attention, args)
        timings[str(dtype)] = {
            "pos": pos, "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(decode_attention_plain, args),
            "library_ms": time_ms(F.scaled_dot_product_attention, lib_args),
            "bound_ms": bound, "bound_by": bound_by,
            "share_of_bound": bound / ms,
        }
        print(f"decode_attention {dtype}: {ms:.5f} ms, "
              f"{100 * bound / ms:.1f}% of its bound: "
              + json.dumps(timings[str(dtype)]))
        del caches, args, lib_args
    report["kernel_sweep"] = sweep
    report["kernel_timings"] = timings
    print(f"kernel vs plain at B={B} H={H} T={T} D={D} block_k={bk}: "
          f"max |err| {max(r['max_abs_err'] for r in sweep):.3e} over "
          f"{len(sweep)} cases (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
    return timings


def phase_flash(report: dict, dev: torch.device) -> dict:
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    B, H, S, D = FLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    checks, timings = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = torch.tensor([], dtype=dtype).element_size()
        # distinct q/k/v sets, so one pass over them overflows the 50 MB L2
        sets = [tuple(torch.randn(FLASH_SHAPE, device=dev, generator=gen)
                      .to(dtype) for _ in range(3))
                for _ in range(2 if dtype is torch.float32 else 3)]
        rtol = KERNEL_RTOL + (BF16_HALF_STEP if dtype is torch.bfloat16
                              else 0.0)
        errs = {}
        for causal in (True, False):
            q, k, v = sets[0]
            got = flash_attention(q, k, v, causal)
            want = flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal)
            torch.cuda.synchronize()
            errs[causal] = (got.float() - want).abs().max().item()
            torch.testing.assert_close(got.float(), want, rtol=rtol,
                                       atol=KERNEL_ATOL)
            checks.append({"dtype": str(dtype), "causal": causal,
                           "shape": FLASH_SHAPE,
                           "max_abs_err": errs[causal], "rtol": rtol})
        bound, bound_by = flash_bound_ms(B, H, S, D, elt)
        ms = time_ms(flash_attention, sets, inner=10)
        timings[str(dtype)] = {
            "max_abs_err": errs[True], "ms": ms,
            "plain_ms": time_ms(flash_attention_plain, sets, inner=10),
            "library_ms": time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), sets, inner=10),
            "bound_ms": bound, "bound_by": bound_by,
            "share_of_bound": bound / ms,
        }
        print(f"flash_attention {dtype}: {ms:.5f} ms, "
              f"{100 * bound / ms:.1f}% of its bound: "
              + json.dumps(timings[str(dtype)]))
        del sets
    # a prompt length that is not a multiple of the kernel's 64-row tile
    q, k, v = (torch.randn(8, 16, 200, 64, device=dev, generator=gen)
               for _ in range(3))
    try:
        flash_attention(q, k, v, block_q=128, block_k=128)
    except ValueError as e:
        print(f"flash_attention S=200, blocks 128: ValueError ({e})")
    else:
        fail("flash_attention took S=200 with blocks of 128")
    for causal in (True, False):
        got = flash_attention(q, k, v, causal, 200, 200)
        want = flash_attention_plain(q, k, v, causal, 200, 200)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        checks.append({"dtype": "torch.float32", "causal": causal,
                       "shape": (8, 16, 200, 64),
                       "max_abs_err": (got - want).abs().max().item(),
                       "rtol": KERNEL_RTOL})
    report["flash_checks"] = checks
    report["flash_timings"] = timings
    print(f"flash vs plain: max |err| "
          f"{max(c['max_abs_err'] for c in checks):.3e} over {len(checks)} "
          f"cases (f32 rtol {KERNEL_RTOL}, bf16 rtol "
          f"{KERNEL_RTOL + BF16_HALF_STEP}, atol {KERNEL_ATOL})")
    return timings


def reset_launches() -> None:
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    decode_attention.launches = 0
    flash_attention.launches = 0


def read_launches() -> dict:
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    return {"decode_attention": decode_attention.launches,
            "flash_attention": flash_attention.launches}


def check_launches(name: str, launches: dict, layers: int) -> None:
    want = {"decode_attention": REQUESTS * (STEPS - 1) * layers,
            "flash_attention": REQUESTS * layers}
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want} "
             f"({REQUESTS} requests x {layers} layers, x {STEPS - 1} decode "
             f"steps for decode_attention)")


def lm_filter_line(prompts, custom: str = "") -> str:
    B, P = prompts[0].shape
    extra = f" custom={custom}" if custom else ""
    return ("appsrc name=in caps=other/tensors,format=static,"
            f"dimensions={P}:{B},types=int32 "
            "! tensor_filter framework=torch "
            f"model=nnstreamer_tpu_torch.models.lm_serving:base{extra} name=f "
            f"! tensor_sink name=out max-stored={len(prompts)}")


def serve(custom: str, prompts) -> dict:
    """Drive the launch line on ``prompts``; return outputs, launches and
    times."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(lm_filter_line(prompts, custom))
    outs, t_out = [], []

    def on_data(buf):
        t = buf.tensors[0]
        torch.cuda.synchronize()
        t_out.append(time.perf_counter())
        outs.append(t)

    pipe.get("out").connect(on_data)
    reset_launches()
    t0 = time.perf_counter()
    pipe.play()
    try:
        src = pipe.get("in")
        for p in prompts:
            src.push_buffer(p)
        src.end_of_stream()
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    launches = read_launches()
    if msg.type is not MessageType.EOS:
        fail(f"pipeline ({custom or 'float32'}): {msg}")
    return {"outs": outs, "launches": launches, "t0": t0, "t_out": t_out}


def phase_slice(report: dict) -> tuple:
    """Returns the prompts and the float32 run's outputs (host)."""
    from nnstreamer_tpu_torch.models.lm_serving import base

    vocab = base.cfg.vocab
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (8, PROMPT)).astype(np.int32)
               for _ in range(REQUESTS)]
    main = None
    report["slice"] = {}
    for custom in ("", "serve_dtype:bfloat16"):
        r = serve(custom, prompts)
        name = custom or "float32"
        if len(r["outs"]) != REQUESTS:
            fail(f"{name}: {len(r['outs'])} outputs for {REQUESTS} requests")
        for p, out in zip(prompts, r["outs"]):
            if not (out.is_cuda and out.dtype is torch.int32
                    and tuple(out.shape) == (8, PROMPT + STEPS)):
                fail(f"{name}: output {out.dtype} {tuple(out.shape)} on "
                     f"{out.device}")
            host = out.cpu().numpy()
            if not np.array_equal(host[:, :PROMPT], p):
                fail(f"{name}: prompt not echoed unchanged")
            if host.min() < 0 or host.max() >= vocab:
                fail(f"{name}: tokens outside [0, {vocab})")
        check_launches(name, r["launches"], base.cfg.layers)
        gen_tokens = 8 * STEPS
        t_out = r["t_out"]
        steady = (REQUESTS - 1) * gen_tokens / (t_out[-1] - t_out[0])
        first_s = t_out[0] - r["t0"]
        report["slice"][name] = {
            "launches": r["launches"],
            "tokens_per_s_steady": steady,
            "request_s_steady": (t_out[-1] - t_out[0]) / (REQUESTS - 1),
            "first_request_s_incl_model_build": first_s,
            "total_s": t_out[-1] - r["t0"],
        }
        print(f"slice {name}: {REQUESTS} x (8, {PROMPT}) -> (8, "
              f"{PROMPT + STEPS}) int32; kernel launches {r['launches']}; "
              f"{steady:.1f} generated tokens/s (requests 2-3); first "
              f"request {first_s:.3f} s incl. model build")
        if main is None:
            main = [o.cpu().numpy() for o in r["outs"]]
    return prompts, main


def generate_pipeline(model: str, props: str, batch: int, plen: int):
    """``appsrc ! tensor_generate ! tensor_sink``; returns the pipeline and
    the list its sink appends (buffer, host time) to."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={plen}:{batch},types=int32 "
        f"! tensor_generate model={model} {props} "
        "! tensor_sink name=out max-stored=1")
    got = []
    pipe.get("out").connect(lambda b: got.append((b, time.perf_counter())))
    return pipe, got


def push_turns(pipe, got, prompts, steps) -> list:
    """Push each prompt once the previous one's last token arrived; return
    the push times. Fails on a bus error or a turn that does not end."""
    from nnstreamer_tpu_torch.core import MessageType

    t_push = []
    pipe.play()
    try:
        for i, p in enumerate(prompts):
            t_push.append(time.perf_counter())
            pipe.get("in").push_buffer(p)
            deadline = time.monotonic() + 600
            while len(got) < (i + 1) * steps:
                msg = pipe.bus.pop(timeout=0.01)
                if msg is not None and msg.type is MessageType.ERROR:
                    fail(f"tensor_generate: {msg}")
                if time.monotonic() > deadline:
                    fail(f"tensor_generate: turn {i} gave {len(got)} of "
                         f"{(i + 1) * steps} buffers in 600 s")
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"tensor_generate: {msg}")
    return t_push


def turn_tokens(got, steps, vocab) -> list:
    """Check the per-token buffers; return each turn's (B, steps) tokens."""
    turns = []
    for t in range(len(got) // steps):
        bufs = [b for b, _ in got[t * steps:(t + 1) * steps]]
        toks = [b.tensors[0] for b in bufs]
        shapes = {(type(x).__name__, str(x.dtype), tuple(x.shape))
                  for x in toks}
        if len(shapes) != 1 or toks[0].dtype != np.int32 \
                or toks[0].shape[1] != 1:
            fail(f"tensor_generate buffers: {sorted(shapes)}, expected one "
                 "host (B, 1) int32")
        if [b.meta.get("gen_step") for b in bufs] != list(range(steps)) or \
                [b.meta.get("gen_last") for b in bufs] != \
                [False] * (steps - 1) + [True]:
            fail(f"tensor_generate turn {t}: gen_step/gen_last framing wrong")
        tok = np.concatenate(toks, axis=1)
        if tok.min() < 0 or tok.max() >= vocab:
            fail(f"tensor_generate: tokens outside [0, {vocab})")
        turns.append(tok)
    return turns


def phase_generate(report: dict, prompts, filter_outs) -> dict:
    from nnstreamer_tpu_torch.models.lm_serving import base

    pipe, got = generate_pipeline(
        "nnstreamer_tpu_torch.models.lm_serving:base", f"steps={STEPS}",
        8, PROMPT)
    reset_launches()
    t_push = push_turns(pipe, got, prompts, STEPS)
    launches = read_launches()
    if len(got) != REQUESTS * STEPS:
        fail(f"tensor_generate: {len(got)} buffers, expected "
             f"{REQUESTS * STEPS}")
    turns = turn_tokens(got, STEPS, base.cfg.vocab)
    for i, (tok, whole) in enumerate(zip(turns, filter_outs)):
        if tok.shape != (8, STEPS) or not np.array_equal(tok,
                                                         whole[:, PROMPT:]):
            fail(f"tensor_generate request {i}: tokens differ from the "
                 "tensor_filter path's generated suffix")
    check_launches("tensor_generate", launches, base.cfg.layers)
    times = [t for _, t in got]
    per = []
    for i in range(REQUESTS):
        first, last = times[i * STEPS], times[(i + 1) * STEPS - 1]
        per.append({"ttft_s": first - t_push[i],
                    "request_s": last - t_push[i],
                    "tokens_per_s": 8 * STEPS / (last - t_push[i])})
    steady = per[1:]
    r = {
        "launches": launches,
        "tokens_per_s_steady": 8 * STEPS * len(steady)
        / sum(p["request_s"] for p in steady),
        "ttft_s_steady": statistics.median(p["ttft_s"] for p in steady),
        "ttft_s_first_incl_model_build": per[0]["ttft_s"],
        "per_request": per,
    }
    report["generate"] = r
    print(f"generate float32: {REQUESTS} x (8, {PROMPT}) -> {STEPS} buffers "
          f"of (8, 1) int32 each, tokens equal to the filter's; kernel "
          f"launches {launches}; {r['tokens_per_s_steady']:.1f} generated "
          f"tokens/s and time to first token {r['ttft_s_steady'] * 1e3:.2f} "
          f"ms (requests 2-3); first request's first token "
          f"{r['ttft_s_first_incl_model_build']:.3f} s incl. model build")
    return r


def phase_parity(report: dict, dev: torch.device) -> None:
    from nnstreamer_tpu_torch.models.decoding import (
        decode_step,
        init_cache,
        prefill,
    )
    from nnstreamer_tpu_torch.models.lm_serving import base

    cfg_k = base.cfg
    # the reference is dense end to end: prefill and decode
    cfg_d = replace(cfg_k, decode_attn="dense", prefill_attn="dense")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(
        rng.integers(0, cfg_k.vocab, (8, PROMPT)).astype(np.int32)).to(dev)
    forced = torch.from_numpy(
        rng.integers(0, cfg_k.vocab, (8, 16)).astype(np.int32)).to(dev)
    report["parity"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        entry = replace(base, serve_dtype=None if dtype is torch.float32
                        else "bfloat16")
        params = entry.build_params(dev)
        with torch.inference_mode():
            caches, first = {}, {}
            for cfg in (cfg_k, cfg_d):
                key = cfg.decode_attn
                first[key], caches[key], pos = prefill(
                    cfg, params, prompt, init_cache(cfg, 8, dtype, dev))
            # the prompt prefill, flash kernel vs dense attention
            pre = (first["kernel"] - first["dense"]).abs().max().item()
            if not pre <= PARITY_ATOL[dtype]:
                fail(f"parity {dtype} prefill: max |logit diff| {pre} "
                     f"> {PARITY_ATOL[dtype]}")
            worst = 0.0
            for i in range(forced.shape[1]):
                lk, caches["kernel"] = decode_step(
                    cfg_k, params, forced[:, i], pos + i, caches["kernel"])
                ld, caches["dense"] = decode_step(
                    cfg_d, params, forced[:, i], pos + i, caches["dense"])
                err = (lk - ld).abs().max().item()
                worst = max(worst, err)
                if not err <= PARITY_ATOL[dtype]:
                    fail(f"parity {dtype} step {i}: max |logit diff| {err} "
                         f"> {PARITY_ATOL[dtype]}")
        report["parity"][str(dtype)] = {"prefill": pre, "decode": worst}
        print(f"teacher-forced parity {dtype} at base width, kernels vs "
              f"dense: prefill of {PROMPT} max |logit diff| {pre:.3e}, "
              f"{forced.shape[1]} decode steps {worst:.3e} "
              f"(atol {PARITY_ATOL[dtype]})")
        del params, caches, first

    # small input against the CPU path, which tests/test_torch_*.py hold
    # token-exact against nnstreamer_tpu: the tiny entry's greedy tokens on
    # the card (through the kernel) equal the CPU's on the same weights
    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.lm_serving import tiny

    cpu_params = tiny.build_params(torch.device("cpu"))
    dev_params = {k: (v.to(dev) if k != "blocks" else
                      [{n: t.to(dev) for n, t in b.items()} for b in v])
                  for k, v in cpu_params.items()}
    small = torch.from_numpy(rng.integers(0, tiny.cfg.vocab, (4, 6))
                             .astype(np.int32))
    gen = make_generate(tiny.cfg)
    with torch.inference_mode():
        want = gen(cpu_params, small, 8)
        got = gen(dev_params, small.to(dev), 8).cpu()
    if not torch.equal(got, want):
        fail(f"tiny greedy tokens on the card differ from the CPU's:\n"
             f"{got}\n{want}")
    report["parity"]["tiny_tokens_equal_cpu"] = True
    print("tiny entry: greedy tokens on the card equal the CPU's")


def phase_conversation(report: dict, dev: torch.device) -> None:
    from nnstreamer_tpu_torch.models.decoding import (
        init_cache,
        prefill,
        prefill_continue,
    )
    from nnstreamer_tpu_torch.models.lm_serving import base, tiny

    rng = np.random.default_rng(3)
    p1 = rng.integers(0, base.cfg.vocab, (8, PROMPT)).astype(np.int32)
    p2 = rng.integers(0, base.cfg.vocab, (8, TURN2_PROMPT)).astype(np.int32)

    # the element: two prompt buffers, the cache kept between them
    pipe, got = generate_pipeline(
        "nnstreamer_tpu_torch.models.lm_serving:base",
        f"steps={TURN_STEPS} conversation=true", 8, PROMPT)
    push_turns(pipe, got, [p1, p2], TURN_STEPS)
    el_turns = turn_tokens(got, TURN_STEPS, base.cfg.vocab)

    # the session API on the same weights, holding turn 2's logits
    cfg = base._cfg_serve
    session = base.make_session(dev)
    g1 = torch.stack(list(session.generate(p1, TURN_STEPS)), 1).cpu().numpy()
    pending, pos, cache = session.state
    params = base.build_params(dev)
    with torch.inference_mode():
        kept = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        feed = torch.cat([pending[:, None],
                          torch.from_numpy(p2).to(dev)], dim=1)
        l_cont, _, _ = prefill_continue(cfg, params, feed, kept, pos)
        history = torch.from_numpy(np.concatenate([p1, g1, p2], axis=1))
        l_fresh, _, _ = prefill(cfg, params, history.to(dev),
                                init_cache(cfg, 8, torch.float32, dev))
    err = (l_cont - l_fresh).abs().max().item()
    if not err <= CONV_ATOL:
        fail(f"conversation: turn 2's first-step logits differ from a "
             f"from-scratch prefill by {err} > {CONV_ATOL}")
    g2 = torch.stack(list(session.generate(p2, TURN_STEPS)), 1).cpu()
    if not torch.equal(g2[:, 0], torch.argmax(l_cont, -1).int().cpu()):
        fail("conversation: turn 2's first token is not its logits' argmax")
    for t, (a, b) in enumerate(zip(el_turns, (g1, g2.numpy()))):
        if not np.array_equal(a, b):
            fail(f"conversation: the element's turn {t + 1} differs from "
                 "the session's")
    report["conversation"] = {"base_logit_max_abs_diff": err,
                              "history_len": history.shape[1]}
    print(f"conversation base: 2 turns through tensor_generate "
          f"conversation=true equal the session API's; "
          f"turn 2's first-step logits (chunked prefill "
          f"of {feed.shape[1]} at pos {pos}) vs a from-scratch prefill of "
          f"{history.shape[1]}: max |diff| {err:.3e} (atol {CONV_ATOL})")
    del session, params, cache, kept, pending

    # the same two turns at tiny on the card and on the CPU, same weights
    cpu_params = tiny.build_params(torch.device("cpu"))
    tree = {k: (v.numpy() if k != "blocks" else
                [{n: t.numpy() for n, t in b.items()} for b in v])
            for k, v in cpu_params.items()}
    entry = replace(tiny, params=tree)
    q1 = rng.integers(0, tiny.cfg.vocab, (4, 6)).astype(np.int32)
    q2 = rng.integers(0, tiny.cfg.vocab, (4, 3)).astype(np.int32)
    toks = {}
    for where in (dev, torch.device("cpu")):
        sess = entry.make_session(where)
        toks[where.type] = [
            torch.stack(list(sess.generate(q, 6)), 1).cpu().numpy()
            for q in (q1, q2)]
    for t, (a, b) in enumerate(zip(toks["cuda"], toks["cpu"])):
        if not np.array_equal(a, b):
            fail(f"tiny conversation turn {t + 1}: card tokens {a} differ "
                 f"from the CPU's {b}")
    report["conversation"]["tiny_tokens_equal_cpu"] = True
    print("conversation tiny: two turns on the card equal the CPU's")


def mb_host_frames(n: int) -> np.ndarray:
    """The frames ``tensor_src pattern=random dimensions=3:224:224:1
    types=uint8`` makes from seed 0, as one (n, 224, 224, 3) array."""
    rng = np.random.default_rng(0)
    return np.concatenate([rng.integers(0, 127, (1, 224, 224, 3))
                           .astype(np.uint8) for _ in range(n)])


def mb_centred_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    def centred(a):
        return a - a.mean(0, keepdim=True)
    return ((centred(got) - centred(want)).abs().max().item(),
            centred(want).std().item())


def mb_forward_breakdown(fn, batches, n: int = 3) -> dict:
    """Device time of one forward by the aten op that launched it (ms, the
    kernels' own time), from a torch.profiler trace of ``n`` forwards;
    "total" sums them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*batches[i % len(batches)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.key.startswith("aten::"):
            out[e.key] = us / 1e3 / n
    out = dict(sorted(out.items(), key=lambda kv: -kv[1]))
    if out:
        out["total"] = sum(out.values())
    return out


def phase_mobilenet_model(report: dict, dev: torch.device) -> None:
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mb
    from nnstreamer_tpu_torch.models._blocks import make_u8_entry

    f32_entry = make_u8_entry(replace(mb.filter_model, compute_dtype="float32"))
    f32_card = f32_entry.make(dev)
    bf16_card = mb.filter_model_u8.make(dev)
    if bf16_card.dtype is not torch.bfloat16 or f32_card.dtype is not torch.float32:
        fail(f"mobilenet: compute dtypes {bf16_card.dtype} (auto on the "
             f"card) and {f32_card.dtype} (float32)")
    x = torch.from_numpy(mb_host_frames(MB_PARITY_FRAMES))
    cpu = f32_entry.make("cpu")(x)
    xd = x.to(dev)
    # main() turns TF32 off for the whole process; the float32 build must
    # compute in float32 whatever the flag says, so it is on here
    torch.backends.cudnn.allow_tf32 = True
    try:
        f32 = f32_card(xd)
        if not torch.backends.cudnn.allow_tf32:
            fail("mobilenet: the float32 forward left cuDNN's TF32 flag off")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    bf16 = bf16_card(xd)
    if not (f32.is_cuda and f32.dtype is torch.float32
            and tuple(f32.shape) == (MB_PARITY_FRAMES, 1001)
            and bool(torch.isfinite(f32).all()) and bool(torch.isfinite(bf16).all())):
        fail(f"mobilenet: logits {f32.dtype} {tuple(f32.shape)} on {f32.device}")
    f32, bf16 = f32.cpu(), bf16.cpu()
    err = (f32 - cpu).abs().max().item()
    cerr, cstd = mb_centred_err(f32, cpu)
    bf_err = (bf16 - f32).abs().max().item()
    r = {"card_f32_vs_cpu_max_abs_err": err,
         "card_f32_vs_cpu_centred_err": cerr, "cpu_centred_std": cstd,
         "max_abs_logit": cpu.abs().max().item(),
         "labels_equal_cpu": bool(torch.equal(f32.argmax(-1), cpu.argmax(-1))),
         "bf16_vs_f32_max_abs_err": bf_err,
         "bf16_labels_equal_f32": bool(torch.equal(bf16.argmax(-1),
                                                   f32.argmax(-1)))}
    print(f"mobilenet parity on {MB_PARITY_FRAMES} frames: card f32 (cuDNN "
          f"TF32 flag on) vs CPU "
          f"max |err| {err:.3e} (atol {MB_LOGIT_ATOL}), centred {cerr:.3e} "
          f"vs centred std {cstd:.3e} (share {MB_CENTRED_SHARE}); bf16 vs f32 "
          f"{bf_err:.3e} (atol {MB_BF16_ATOL})")
    if not (err <= MB_LOGIT_ATOL and cerr <= MB_CENTRED_SHARE * cstd
            and r["labels_equal_cpu"]):
        fail(f"mobilenet: card f32 logits differ from the CPU's: {r}")
    if not bf_err <= MB_BF16_ATOL:
        fail(f"mobilenet: bf16 logits differ from f32 by {bf_err}")
    # forward time at batch 64 over distinct inputs (4 × 9.6 MB of frames)
    gen = torch.Generator(device=dev).manual_seed(4)
    batches = [(torch.randint(0, 127, (MB_BATCH, 224, 224, 3), generator=gen,
                              device=dev, dtype=torch.uint8),)
               for _ in range(4)]
    for name, fn in (("bfloat16", bf16_card), ("float32", f32_card)):
        r[f"forward_ms_{name}"] = time_ms(fn, batches, reps=7, inner=5,
                                          sleep_cycles=200_000_000)
    # the host's time to issue one forward (the call returns once every
    # launch is queued; the card runs behind it), at batch 64 and 1
    for b in (MB_BATCH, 1):
        issue = []
        for i in range(10):
            x1 = batches[i % len(batches)][0][:b]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bf16_card(x1)
            issue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        r[f"issue_ms_bfloat16_batch{b}"] = 1e3 * statistics.median(issue[2:])
    r["forward_breakdown_ms_bfloat16"] = mb_forward_breakdown(bf16_card, batches)
    print(f"mobilenet filter_model_u8 forward at batch {MB_BATCH}: bf16 "
          f"{r['forward_ms_bfloat16']:.4f} ms, f32 {r['forward_ms_float32']:.4f}"
          f" ms ({MB_BATCH * 1e3 / r['forward_ms_bfloat16']:.1f} / "
          f"{MB_BATCH * 1e3 / r['forward_ms_float32']:.1f} frames/s); host "
          f"time to issue one bf16 forward "
          f"{r[f'issue_ms_bfloat16_batch{MB_BATCH}']:.3f} ms at batch "
          f"{MB_BATCH}, {r['issue_ms_bfloat16_batch1']:.3f} ms at batch 1")
    top = [kv for kv in r["forward_breakdown_ms_bfloat16"].items()
           if kv[0] != "total"][:8]
    print("mobilenet bf16 forward, device ms by aten op (profiler): "
          + ("not measured (no device time in the trace)" if not top else
             ", ".join(f"{k} {v:.4f}" for k, v in top) + " of "
             f"{r['forward_breakdown_ms_bfloat16']['total']:.4f} in all"))
    report["mobilenet"] = {"model": r}


MB_HEAD = ("tensor_src num-buffers={n} dimensions=3:224:224:1 types=uint8 "
           "pattern=random ! tensor_aggregator frames-out={b} frames-dim=0 "
           "concat=true ! queue max-size-buffers=4 ")
MB_FILTER = (f"! tensor_filter framework=torch model={MB_MODEL} "
             "sync-invoke=false name=f ")
MB_LABEL = "! tensor_decoder mode=image_labeling frames-in={b} name=d "


def mb_lines() -> dict:
    n, b = (MB_WARM + MB_MEASURED) * MB_BATCH, MB_BATCH
    head = MB_HEAD.format(n=n, b=b) + MB_FILTER
    label = MB_LABEL.format(b=b)
    return {
        "host": head + "! queue max-size-buffers=4 ! tensor_sink name=out "
                       "max-stored=1",
        "labeling": head + label + "! tensor_sink name=out max-stored=1",
        "device": (f"tensor_src device=true pattern=random num-buffers="
                   f"{MB_WARM + MB_MEASURED} dimensions=3:224:224:{b} "
                   f"types=uint8 {MB_FILTER}! queue max-size-buffers=4 "
                   f"{label}! tensor_sink name=out max-stored=1"),
    }


def mb_run_line(name: str, line: str) -> dict:
    """Drive one line; the filter is tapped for its input batches and the
    argmax of its logits (launches made for the checks do not count)."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(line)
    filt = pipe.get("f")
    inputs, argmax, devices, filter_s, decoder_s = [], [], set(), [], []
    transform = filt.transform

    def tapped(buf):
        t0 = time.perf_counter()
        out = transform(buf)
        filter_s.append(time.perf_counter() - t0)
        inputs.append(buf.tensors[0])
        argmax.append(out.tensors[0].argmax(-1))
        devices.add((str(filt.backend_device), str(out.tensors[0].device)))
        return out

    filt.transform = tapped
    host_decodes = []
    if name != "host":
        dec = pipe.get("d")
        chain = dec.chain
        # the host decode pulls a batch's full logits; the reduce path
        # pulls one int32 label per frame, and must be the one taken
        host_decode = dec.decoder.decode

        def counted_decode(buf, info):
            host_decodes.append(1)
            return host_decode(buf, info)

        dec.decoder.decode = counted_decode

        def timed_chain(pad, buf):
            t0 = time.perf_counter()
            chain(pad, buf)
            decoder_s.append(time.perf_counter() - t0)

        dec.chain = timed_chain
    times, labels = [], []
    labeling = name != "host"

    def on_data(buf):
        if labeling:
            labels.append(buf.meta["labels"])
        else:
            t = buf.tensors[0]
            if not (t.is_cuda and tuple(t.shape) == (MB_BATCH, 1001)):
                fail(f"mobilenet {name}: sink got {t.dtype} "
                     f"{tuple(t.shape)} on {t.device}")
            torch.cuda.synchronize()
        times.append(time.perf_counter())

    pipe.get("out").connect(on_data)
    reset_launches()
    pipe.play()
    try:
        msg = pipe.wait(timeout=300)
        stats = filt.stats.snapshot()
    finally:
        pipe.stop()
    launches = read_launches()
    if msg.type is not MessageType.EOS:
        fail(f"mobilenet {name} line: {msg}")
    n_batches = MB_WARM + MB_MEASURED
    if devices != {("cuda:0", "cuda:0")}:
        fail(f"mobilenet {name}: filter (backend device, output device) "
             f"{sorted(devices)}, expected cuda:0 for both")
    if len(inputs) != n_batches:
        fail(f"mobilenet {name}: {len(inputs)} filter invocations for "
             f"{n_batches} batches")
    want = torch.cat(argmax).cpu().tolist()
    per_batch = MB_BATCH if labeling else 1
    if len(times) != n_batches * per_batch:
        fail(f"mobilenet {name}: {len(times)} buffers at the sink, expected "
             f"{n_batches * per_batch}")
    if labeling:
        if host_decodes:
            fail(f"mobilenet {name}: the decoder decoded {len(host_decodes)} "
                 "frames on the host instead of reducing the batch on the card")
        if any(len(ls) != 1 for ls in labels):
            fail(f"mobilenet {name}: a label buffer holds "
                 f"{max(len(ls) for ls in labels)} labels, expected one")
        if [int(ls[0]) for ls in labels] != want:
            fail(f"mobilenet {name}: labels differ from the argmax of the "
                 "filter's logits")
    if name == "device":
        first = inputs[0]
        if not (first.is_cuda and first.dtype is torch.uint8
                and int(first.min()) >= 0 and int(first.max()) < 127):
            fail(f"mobilenet device: tensor_src frames {first.dtype} on "
                 f"{first.device}")
    else:
        frames = mb_host_frames(n_batches * MB_BATCH)
        got = np.concatenate([np.asarray(t) for t in inputs])
        if not np.array_equal(got, frames):
            fail(f"mobilenet {name}: the filter's input differs from the "
                 "frames regenerated from the seed")
    ends = times[per_batch - 1::per_batch]
    fps = MB_MEASURED * MB_BATCH / (ends[-1] - ends[MB_WARM - 1])
    steady = slice(MB_WARM, None)
    return {"frames_per_s": fps, "batches": n_batches,
            "batch_ms_median": 1e3 * statistics.median(
                b - a for a, b in zip(ends[MB_WARM - 1:], ends[MB_WARM:])),
            # host time of the filter's transform per batch (H2D copy and
            # the forward's launches; the device runs behind it), and of
            # the decoder's chain (its one pull waits for the forward)
            "filter_host_ms_median": 1e3 * statistics.median(filter_s[steady]),
            "decoder_ms_median": (1e3 * statistics.median(decoder_s[steady])
                                  if decoder_s else None),
            "launches": launches, "filter_stats": stats,
            "labels": len(labels), "distinct_labels": len(set(want))}


def mb_device_busy(name: str, line: str, per_batch: Optional[int] = None,
                   fuse: Optional[bool] = None) -> dict:
    """The card's busy share over a steady window of a line: a torch.profiler
    trace (CUDA activity only, so the host is not slowed by op records)
    started before the pipeline plays and stopped after it has stopped, so
    that no thread launches work while the profiler starts or stops. The
    window is marked on the card's own timeline: a marker kernel
    (``torch.cuda._sleep``) launched once MB_WARM batches reached the sink,
    and another MB_PROFILED batches later after a synchronize. Busy = the
    union of the kernels' and copies' intervals between the two markers,
    over the time between them. None where the window holds no device
    activity. ``per_batch`` counts the sink buffers of one batch (default:
    1 for the host line, MB_BATCH for the labeling lines); ``fuse`` goes
    to ``parse_launch``."""
    import re
    import threading

    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    line = re.sub(r"num-buffers=\d+ ", "num-buffers=-1 ", line)
    if per_batch is None:
        per_batch = 1 if name == "host" else MB_BATCH
    seen = [0]
    cond = threading.Condition()

    def on_data(buf):
        with cond:
            seen[0] += 1
            cond.notify_all()

    def wait_for_batches(k: float) -> float:
        with cond:
            if not cond.wait_for(lambda: seen[0] >= k * per_batch, timeout=300):
                fail(f"mobilenet {name} profiled run: {seen[0]} buffers at "
                     f"the sink, waiting for {k} batches")
            return seen[0] / per_batch

    prof = profile(activities=[ProfilerActivity.CUDA])
    pipe = parse_launch(line, fuse=fuse)
    pipe.get("out").connect(on_data)
    prof.start()
    try:
        pipe.play()
        try:
            wait_for_batches(MB_WARM)
            torch.cuda._sleep(1000)              # marker: the window opens
            k0 = wait_for_batches(0)
            wait_for_batches(k0 + MB_PROFILED)
            torch.cuda.synchronize()
            k1 = wait_for_batches(0)
            torch.cuda._sleep(1000)              # marker: the window closes
        finally:
            pipe.stop()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    while (msg := pipe.bus.pop(timeout=0)) is not None:
        if msg.type is MessageType.ERROR:
            fail(f"mobilenet {name} profiled run: {msg}")
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = sorted(e.time_range.start for e in events
                   if "spin_kernel" in e.name)
    if len(marks) != 2:
        fail(f"mobilenet {name} profiled run: {len(marks)} window markers "
             "in the trace, expected 2")
    lo, hi = marks
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events if "spin_kernel" not in e.name
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    wall_us = hi - lo
    return {"busy_share": busy / wall_us if spans else None,
            "device_events_per_batch": len(spans) / (k1 - k0),
            "window_ms": wall_us / 1e3, "batches": k1 - k0}


def frame_latency(name: str, model: str, dec: str, check) -> dict:
    """Push one (1, 224, 224, 3) uint8 frame through ``appsrc !
    tensor_filter model=<model> ! tensor_decoder <dec> ! tensor_sink``,
    wait for its decoded buffer; p50 over MB_P50_FRAMES frames after
    MB_P50_WARM warm-up frames. ``check(buf)`` holds each decoded buffer."""
    import threading

    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        "dimensions=3:224:224:1,types=uint8 ! tensor_filter framework=torch "
        f"model={model} name=f ! tensor_decoder {dec} "
        "! tensor_sink name=out max-stored=1")
    arrived = threading.Event()
    got = []

    def on_decoded(buf):
        got.append(bool(check(buf)))
        arrived.set()

    pipe.get("out").connect(on_decoded)
    frames = mb_host_frames(MB_P50_WARM + MB_P50_FRAMES)
    lat = []
    pipe.play()
    try:
        for i in range(len(frames)):
            arrived.clear()
            t0 = time.perf_counter()
            pipe.get("in").push_buffer(frames[i:i + 1])
            if not arrived.wait(timeout=120):
                fail(f"{name} latency: frame {i} gave nothing in 120 s")
            lat.append(time.perf_counter() - t0)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS or len(got) != len(frames) \
            or not all(got):
        fail(f"{name} latency line: {msg}, {len(got)} decoded buffers, "
             f"{got.count(False)} failed the check")
    steady = lat[MB_P50_WARM:]
    return {"p50_ms": 1e3 * statistics.median(steady),
            "p90_ms": 1e3 * float(np.percentile(steady, 90)),
            "first_ms_incl_model_build": 1e3 * lat[0],
            "frames": len(steady)}


def mb_latency() -> dict:
    """Push one frame, wait for its label; p50 over MB_P50_FRAMES frames
    after MB_P50_WARM warm-up frames."""
    return frame_latency("mobilenet", MB_MODEL, "mode=image_labeling",
                         lambda buf: len(buf.meta["labels"]) == 1)


def mb_host_costs() -> dict:
    """The host's per-frame cost of the bench line's head: tensor_src
    making a random (1, 224, 224, 3) uint8 frame, and tensor_aggregator
    taking it into a 64-frame batch (its concat included)."""
    from nnstreamer_tpu_torch.core import Event, parse_caps_string
    from nnstreamer_tpu_torch.registry.elements import make_element

    src = make_element("tensor_src", dimensions="3:224:224:1", types="uint8",
                       pattern="random")
    n = 4 * MB_BATCH
    t0 = time.perf_counter()
    for _ in range(n):       # each frame dropped, as the aggregator's concat does
        src.create()
    src_ms = 1e3 * (time.perf_counter() - t0) / n
    bufs = [src.create() for _ in range(n)]
    agg = make_element("tensor_aggregator", frames_out=MB_BATCH)
    make_element("appsrc").link(agg)
    agg.handle_sink_event(agg.sinkpad, Event.caps(parse_caps_string(
        "other/tensors,format=static,dimensions=3:224:224:1,types=uint8")))
    t0 = time.perf_counter()
    for b in bufs:
        agg.chain(agg.sinkpad, b)
    agg_ms = 1e3 * (time.perf_counter() - t0) / n
    return {"tensor_src_ms_per_frame": src_ms,
            "aggregator_ms_per_frame": agg_ms}


def phase_mobilenet_lines(report: dict) -> None:
    r = report["mobilenet"]
    r["host_costs"] = mb_host_costs()
    print(f"mobilenet host head per frame: tensor_src "
          f"{r['host_costs']['tensor_src_ms_per_frame']:.4f} ms, aggregator "
          f"{r['host_costs']['aggregator_ms_per_frame']:.4f} ms")
    r["lines"] = {}
    for name, line in mb_lines().items():
        res = mb_run_line(name, line)
        r["lines"][name] = res
        checked = ("host frames equal the seed's" if name == "host" else
                   f"{res['labels']} label buffers, one per frame, equal to "
                   "the filter's argmax")
        dec_ms = res["decoder_ms_median"]
        print(f"mobilenet {name} line: {res['frames_per_s']:.1f} frames/s "
              f"({MB_MEASURED} batches of {MB_BATCH} after {MB_WARM} "
              f"warm-up; median batch {res['batch_ms_median']:.3f} ms; host "
              f"per batch: filter {res['filter_host_ms_median']:.3f} ms"
              + (f", decoder {dec_ms:.3f} ms" if dec_ms is not None else "")
              + f"); {checked}")
    for name, line in mb_lines().items():
        busy = mb_device_busy(name, line)
        r["lines"][name]["device"] = busy
        share = busy["busy_share"]
        print(f"mobilenet {name} line, profiled window of "
              f"{busy['batches']:.2f} batches ({busy['window_ms']:.3f} ms): "
              "card busy "
              + ("not measured (no device activity in the trace)"
                 if share is None else f"{100 * share:.1f}%")
              + f", {busy['device_events_per_batch']:.1f} device events "
              "per batch")
    r["latency_batch1"] = mb_latency()
    print(f"mobilenet batch-1 push-to-label latency: p50 "
          f"{r['latency_batch1']['p50_ms']:.3f} ms, p90 "
          f"{r['latency_batch1']['p90_ms']:.3f} ms over "
          f"{MB_P50_FRAMES} frames")


# raw-media phase: the tentpole's line at full width (224×224×3 frames in
# batches of MB_BATCH) into the float entry, bf16 on the card
VL_SIZE = 224
VL_MODEL = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model"
VL_NORM = "typecast:float32,add:-127.5,div:127.5"
# the line's logits (float32 (x - 127.5) / 127.5, rounded to bf16 at the
# model's input) vs the filter_model_u8 forward (bf16 x * (1/127.5) - 1):
# the inputs differ by at most one bf16 step, so the logits by about the
# bf16-vs-f32 gap of phase 8 (1.45e-4); held to phase 8's bf16 limit
VL_U8_ATOL = MB_BF16_ATOL


def vl_line(n_batches: int, labels: Path) -> str:
    b = MB_BATCH
    return (f"videotestsrc num-buffers={n_batches * b} pattern=gradient ! "
            "videoconvert ! videoscale ! "
            f"video/x-raw,width={VL_SIZE},height={VL_SIZE},format=RGB ! "
            f"tensor_converter frames-per-tensor={b} ! tensor_transform "
            f"mode=arithmetic option={VL_NORM} name=tr ! "
            "queue max-size-buffers=4 ! tensor_filter framework=torch "
            f"model={VL_MODEL} name=f ! tensor_decoder mode=image_labeling "
            f"option1={labels} frames-in={b} name=d ! "
            "tensor_sink name=out max-stored=1")


def vl_frames(first: int, n: int) -> np.ndarray:
    """Gradient frames first..first+n-1 as videotestsrc builds them: a
    0..255 ramp along x in every channel, channel 0 shifted by the frame
    index (mod 256)."""
    xx = np.linspace(0, 255, VL_SIZE, dtype=np.uint8)
    out = np.empty((n, VL_SIZE, VL_SIZE, 3), np.uint8)
    out[:] = xx[None, None, :, None]
    idx = np.arange(first, first + n)[:, None, None]
    out[..., 0] = (xx.astype(np.int32)[None, None, :] + idx) % 256
    return out


def vl_same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def vl_run_line(labels: Path) -> dict:
    """Drive the line; the transform is tapped for its input and output
    batches, its host time and its device time (CUDA events on its
    thread's stream), the filter for its logits."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.models.mobilenet_v2 import filter_model_u8
    from nnstreamer_tpu_torch.ops.transform_ops import parse_transform_options
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n_batches = MB_WARM + MB_MEASURED
    pipe = parse_launch(vl_line(n_batches, labels))
    tr, filt = pipe.get("tr"), pipe.get("f")
    tr_in, tr_out, tr_host, tr_events, logits, devices = [], [], [], [], [], set()
    transform, filter_transform = tr.transform, filt.transform

    def tapped_transform(buf):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = transform(buf)
        tr_host.append(time.perf_counter() - t0)
        end.record()
        tr_events.append((start, end))
        tr_in.append(buf.tensors[0])
        tr_out.append(out.tensors[0])
        return out

    def tapped_filter(buf):
        out = filter_transform(buf)
        logits.append(out.tensors[0])
        devices.add((str(buf.tensors[0].device), str(filt.backend_device),
                     str(out.tensors[0].device)))
        return out

    tr.transform, filt.transform = tapped_transform, tapped_filter
    times, labels_got = [], []

    def on_label(buf):
        labels_got.append(buf.meta["label_indices"])
        times.append(time.perf_counter())

    pipe.get("out").connect(on_label)
    reset_launches()
    pipe.play()
    try:
        msg = pipe.wait(timeout=300)
    finally:
        pipe.stop()
    launches = read_launches()
    if msg.type is not MessageType.EOS:
        fail(f"video line: {msg}")
    if len(tr_out) != n_batches or len(logits) != n_batches:
        fail(f"video line: {len(tr_out)} transformed batches, {len(logits)} "
             f"filter invocations for {n_batches} batches")
    if devices != {("cuda:0", "cuda:0", "cuda:0")}:
        fail(f"video line: (transform output, filter backend, filter output) "
             f"devices {sorted(devices)}, expected cuda:0 for all")
    # the source's frames, as the converter stacked them
    for i, x in enumerate(tr_in):
        if not (isinstance(x, np.ndarray)
                and np.array_equal(x, vl_frames(i * MB_BATCH, MB_BATCH))):
            fail(f"video line: batch {i} of the converter differs from the "
                 "gradient frames rebuilt on the host")
    # the card's transform vs the port's CPU transform of the same frames
    fn = parse_transform_options("arithmetic", VL_NORM)
    for i, (x, y) in enumerate(zip(tr_in, tr_out)):
        if not (y.dtype is torch.float32
                and tuple(y.shape) == (MB_BATCH, VL_SIZE, VL_SIZE, 3)
                and vl_same_bits(y.cpu(), fn(torch.from_numpy(x)))):
            fail(f"video line: batch {i}: the card's transform "
                 f"({y.dtype} {tuple(y.shape)}) differs from the CPU's")
    # one label per frame, the argmax of the filter's logits for it
    want = torch.cat([t.argmax(-1) for t in logits]).cpu().tolist()
    if len(labels_got) != n_batches * MB_BATCH or any(
            len(ls) != 1 for ls in labels_got):
        fail(f"video line: {len(labels_got)} label buffers for "
             f"{n_batches * MB_BATCH} frames")
    if [ls[0] for ls in labels_got] != want:
        fail("video line: labels differ from the argmax of the filter's logits")
    # the logits vs the filter_model_u8 forward on the same uint8 frames
    u8 = filter_model_u8.make()
    u8_err, u8_labels = 0.0, 0
    for i in (0, n_batches - 1):
        ref = u8(torch.from_numpy(tr_in[i]).to(logits[i].device))
        if not (bool(torch.isfinite(logits[i]).all())
                and tuple(logits[i].shape) == (MB_BATCH, 1001)):
            fail(f"video line: logits {tuple(logits[i].shape)} not finite")
        u8_err = max(u8_err, (logits[i] - ref).abs().max().item())
        u8_labels += int((logits[i].argmax(-1) == ref.argmax(-1)).sum())
    if not u8_err <= VL_U8_ATOL:
        fail(f"video line: logits differ from filter_model_u8's by {u8_err} "
             f"(atol {VL_U8_ATOL})")
    torch.cuda.synchronize()
    steady = slice(MB_WARM, None)
    dev_ms = [a.elapsed_time(b) for a, b in tr_events]
    ends = times[MB_BATCH - 1::MB_BATCH]
    return {
        "frames_per_s": MB_MEASURED * MB_BATCH / (ends[-1] - ends[MB_WARM - 1]),
        "batch_ms_median": 1e3 * statistics.median(
            b - a for a, b in zip(ends[MB_WARM - 1:], ends[MB_WARM:])),
        "transform_host_ms_median": 1e3 * statistics.median(tr_host[steady]),
        "transform_device_ms_median": statistics.median(dev_ms[steady]),
        "transform_bit_equal_cpu": True,
        "logits_vs_u8_max_abs_err": u8_err,
        "labels_equal_u8_of_2_batches": u8_labels,
        "labels": len(labels_got), "distinct_labels": len(set(want)),
        "launches": launches}


def vl_round_trip(labels: Path) -> dict:
    """The transformed batch through ``tensor_decoder mode=protobuf !
    tensor_converter`` and back, beside the batch itself."""
    from nnstreamer_tpu_torch.core import MessageType, TensorFormat
    from nnstreamer_tpu_torch.core.wire_protobuf import encode_tensors
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    head = vl_line(2, labels).split(" ! queue max-size-buffers=4")[0]
    pipe = parse_launch(
        head + " ! tee name=t t. ! queue ! tensor_decoder mode=protobuf "
        "name=d ! tensor_converter ! tensor_sink name=back max-stored=0 "
        "t. ! queue ! tensor_sink name=orig max-stored=0")
    dec = pipe.get("d")
    decode, blobs, encode_s = dec.decoder.decode, [], []

    def tapped_decode(buf, info):
        t0 = time.perf_counter()
        out = decode(buf, info)
        encode_s.append(time.perf_counter() - t0)
        blobs.append(out.tensors[0])
        return out

    dec.decoder.decode = tapped_decode
    back, orig = [], []
    pipe.get("back").connect(back.append)
    pipe.get("orig").connect(orig.append)
    pipe.play()
    try:
        msg = pipe.wait(timeout=300)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS or not (len(back) == len(orig) == 2):
        fail(f"protobuf round trip: {msg}, {len(orig)} batches, "
             f"{len(back)} back")
    for o, b, blob in zip(orig, back, blobs):
        t = o.tensors[0]
        host = t.cpu().numpy()
        if not t.is_cuda:
            fail(f"protobuf round trip: the batch is on {t.device}")
        if bytes(blob) != encode_tensors([host], [""], TensorFormat.STATIC):
            fail("protobuf round trip: the wire bytes of a CUDA batch differ "
                 "from those of its CPU copy")
        got = np.asarray(b.tensors[0])
        if not (got.dtype == host.dtype and got.shape == host.shape
                and got.tobytes() == host.tobytes()):
            fail("protobuf round trip: the converter's tensor differs from "
                 "the batch's CPU copy")
    return {"batches": len(orig), "wire_bytes_per_batch": len(blobs[0]),
            "encode_ms_median": 1e3 * statistics.median(encode_s)}


def vl_host_costs() -> dict:
    """The host's cost of the line's head: one 224×224×3 gradient frame
    made by videotestsrc, and tensor_converter stacking MB_BATCH of them
    into a batch."""
    from nnstreamer_tpu_torch.core import parse_caps_string
    from nnstreamer_tpu_torch.registry.elements import make_element

    src = make_element("videotestsrc", width=VL_SIZE, height=VL_SIZE,
                       pattern="gradient")
    n = 4 * MB_BATCH
    t0 = time.perf_counter()
    bufs = [src.create() for _ in range(n)]
    src_ms = 1e3 * (time.perf_counter() - t0) / n
    conv = make_element("tensor_converter", frames_per_tensor=MB_BATCH)
    conv.set_caps(conv.sinkpad, parse_caps_string(
        f"video/x-raw,format=RGB,width={VL_SIZE},height={VL_SIZE}"))
    t0 = time.perf_counter()
    out = [b for b in map(conv.transform, bufs) if b is not None]
    conv_ms = 1e3 * (time.perf_counter() - t0) / len(out)
    return {"videotestsrc_ms_per_frame": src_ms,
            "converter_ms_per_batch": conv_ms}


def phase_video_line(report: dict) -> None:
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    labels = out_dir / "labels_1001.txt"
    labels.write_text("".join(f"class{i}\n" for i in range(1001)))
    r = {"host_costs": vl_host_costs()}
    print(f"video line host head: videotestsrc "
          f"{r['host_costs']['videotestsrc_ms_per_frame']:.4f} ms a frame, "
          f"tensor_converter {r['host_costs']['converter_ms_per_batch']:.3f}"
          f" ms a batch of {MB_BATCH}")
    r["line"] = res = vl_run_line(labels)
    print(f"video line: {res['frames_per_s']:.1f} frames/s ({MB_MEASURED} "
          f"batches of {MB_BATCH} after {MB_WARM} warm-up; median batch "
          f"{res['batch_ms_median']:.3f} ms); tensor_transform per batch: "
          f"host {res['transform_host_ms_median']:.3f} ms (H2D copy and "
          f"launches), device {res['transform_device_ms_median']:.3f} ms; "
          "card transform bit-equal to the CPU's; "
          f"{res['labels']} label buffers, one per frame, equal to the "
          f"filter's argmax; logits vs filter_model_u8 max |err| "
          f"{res['logits_vs_u8_max_abs_err']:.3e} (atol {VL_U8_ATOL}), "
          f"{res['labels_equal_u8_of_2_batches']} of {2 * MB_BATCH} labels "
          "equal")
    r["protobuf_round_trip"] = rt = vl_round_trip(labels)
    print(f"video line protobuf round trip: {rt['batches']} CUDA batches, "
          f"{rt['wire_bytes_per_batch']} wire bytes each equal to their CPU "
          f"copy's, back through tensor_converter unchanged; encode "
          f"{rt['encode_ms_median']:.3f} ms a batch")
    r["device"] = busy = mb_device_busy("video", vl_line(MB_WARM + MB_MEASURED,
                                                         labels))
    share = busy["busy_share"]
    print(f"video line, profiled window of {busy['batches']:.2f} batches "
          f"({busy['window_ms']:.3f} ms): card busy "
          + ("not measured (no device activity in the trace)"
             if share is None else f"{100 * share:.1f}%")
          + f", {busy['device_events_per_batch']:.1f} device events per batch")
    report["video_line"] = r


# continuous serving (phase 10): slot positions of the per-slot kernel
# check, requests, waves and steps, the paged engine's knobs, the shared
# prefix, the draft burst, tensor_serving frames per stream
CS_POS = (0, 17, 130, 543, 1023, 1500, 2000, 2047)
CS_SLOTS, CS_REQUESTS, CS_STEPS, CS_PROMPT_RANGE = 8, 24, 64, (64, 512)
CS_PAGE, CS_CHUNK, CS_PREFIX, CS_SHARED = 16, 64, 256, 8
CS_SHARED_TAIL = (16, 64)   # tokens after the shared prefix
CS_SPEC_K, CS_SPEC_REQUESTS = 4, 8
# a greedy mismatch passes only at a near tie of the batch-1 run
CS_TIE_MARGIN = 1e-4
TS_FRAMES = 32
TS_MODEL = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8"


def cs_slot_kernel(dev: torch.device) -> dict:
    """(a): the decode kernel with a (B,) position vector at base shapes."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    s = BASE_SHAPE
    B, H, T, D, bk = s["B"], s["H"], s["T"], s["D"], s["block_k"]
    gen = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn(B, H, 1, D, device=dev, generator=gen)
    pos = torch.tensor(CS_POS, dtype=torch.int32, device=dev)
    # SDPA's per-row boolean mask (True = attend), (B, 1, 1, T)
    mask = (torch.arange(T, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    n = [p + 1 for p in CS_POS]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = torch.tensor([], dtype=dtype).element_size()
        caches = [(torch.randn(B, H, T, D, device=dev, generator=gen).to(dtype),
                   torch.randn(B, H, T, D, device=dev, generator=gen).to(dtype))
                  for _ in range(4 if dtype is torch.float32 else 6)]
        k, v = caches[0]
        got = decode_attention(q, k, v, pos, bk)
        want = decode_attention_plain(q, k, v, pos, bk)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        # each slot equals the kernel on that slot alone at its position
        for b, p in enumerate(CS_POS):
            one = decode_attention(q[b:b + 1].contiguous(),
                                   k[b:b + 1].contiguous(),
                                   v[b:b + 1].contiguous(), p, bk)
            torch.testing.assert_close(got[b:b + 1], one, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
        args = [(q, ck, cv, pos, bk) for ck, cv in caches]
        q_lib = q.to(dtype)
        lib_args = [(q_lib, ck, cv, mask) for ck, cv in caches]
        nbytes = (sum(2 * H * m * D * elt for m in n) + 2 * B * H * D * 4
                  + 4 * B)
        flops = sum(4 * H * m * D + H * m for m in n)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        ms = time_ms(decode_attention, args)
        out[str(dtype)] = {
            "pos": list(CS_POS), "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(decode_attention_plain, args),
            "library_ms": time_ms(
                lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mm), lib_args),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        out[str(dtype)]["share_of_bound"] = \
            out[str(dtype)]["bound_ms"] / ms
        print(f"decode_attention per-slot pos {dtype}: {ms:.5f} ms, "
              f"{100 * out[str(dtype)]['share_of_bound']:.1f}% of its bound: "
              + json.dumps(out[str(dtype)]))
        del caches, args, lib_args
    return out


def cs_prompts(n: int, vocab: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    lo, hi = CS_PROMPT_RANGE
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def cs_run(sched, prompts, steps: int, on_wait=None) -> dict:
    """Submit ``prompts`` in waves of CS_SLOTS, each wave when the previous
    one is half done; return the tokens and the wall time."""
    reqs = []
    t0 = time.perf_counter()
    for w in range(0, len(prompts), CS_SLOTS):
        prev = reqs[-CS_SLOTS:]
        while prev and min(len(r.tokens) for r in prev) < steps // 2 \
                and not all(r.done() for r in prev):
            if on_wait is not None:
                on_wait()
            time.sleep(0.002)
        reqs += [sched.submit(p, steps=steps) for p in prompts[w:w + CS_SLOTS]]
    while not all(r.done() for r in reqs):
        if on_wait is not None:
            on_wait()
        time.sleep(0.002)
    wall = time.perf_counter() - t0
    return {"tokens": [r.result(1)[0].tolist() for r in reqs],
            "wall_s": wall}


def cs_margin(cfg, params, prompt, tokens, j: int, dev) -> float:
    """Top-2 logit margin of the batch-1 run at generated step ``j``,
    teacher-forced along ``tokens[:j]``."""
    from nnstreamer_tpu_torch.models.decoding import (
        decode_step,
        init_cache,
        prefill,
    )

    with torch.inference_mode():
        cache = init_cache(cfg, 1, params["embed"].dtype, dev)
        logits, cache, pos = prefill(
            cfg, params, torch.from_numpy(prompt[None]).to(dev), cache)
        for i in range(j):
            tok = torch.tensor([tokens[i]], dtype=torch.int32, device=dev)
            logits, cache = decode_step(cfg, params, tok, pos + i, cache)
        top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def cs_compare(name: str, got, want, prompts, cfg, params, dev) -> list:
    """``got`` equal to ``want`` stream by stream, but at a near tie of the
    batch-1 run (margin below CS_TIE_MARGIN at the first differing step),
    after which that stream is not compared. Returns the ties."""
    ties = []
    for i, (g, w, p) in enumerate(zip(got, want, prompts)):
        if len(g) != len(w):
            fail(f"{name} request {i}: {len(g)} tokens, expected {len(w)}")
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        m = cs_margin(cfg, params, p, w, j, dev)
        if not m < CS_TIE_MARGIN:
            fail(f"{name} request {i}: token {j} is {g[j]}, expected {w[j]} "
                 f"(batch-1 top-2 margin {m} >= {CS_TIE_MARGIN})")
        ties.append({"request": i, "step": j, "margin": m})
        print(f"{name} request {i}: near tie at step {j} (batch-1 top-2 "
              f"margin {m:.3e} < {CS_TIE_MARGIN}); later steps not compared")
    return ties


def cs_engine_stats(name: str, sched, wall: float, n_tokens: int) -> dict:
    snap = sched.metrics_snapshot()
    steps = snap["decode_steps"]
    r = {"generated_tokens": n_tokens, "wall_s": wall,
         "tokens_per_s": n_tokens / wall,
         "ttft_ms_p50": snap["ttft"]["p50_ms"],
         "ttft_ms_p99": snap["ttft"]["p99_ms"],
         "step_ms_mean": snap["device"]["avg_dispatch_latency_ms"],
         "decode_steps": steps,
         "mean_active_slots": snap["batch_occupancy"] * CS_SLOTS,
         "preempted": snap["preempted"]}
    print(f"{name}: {n_tokens} generated tokens in {wall:.3f} s = "
          f"{r['tokens_per_s']:.1f} tokens/s; time to first token p50 "
          f"{r['ttft_ms_p50']:.2f} ms, p99 {r['ttft_ms_p99']:.2f} ms; "
          f"{steps} decode steps of {r['step_ms_mean']:.3f} ms (mean, host "
          f"clock incl. the token copy); mean active slots "
          f"{r['mean_active_slots']:.2f} of {CS_SLOTS}")
    return r


def cs_step_breakdown(eng, prompts, n: int = 20) -> dict:
    """Where one dense decode step's time goes, all slots active: host
    ms per step (wall clock, the step ends in its token copy), the card's
    busy share over ``n`` steps (CUDA-only profile: the union of kernel
    and copy intervals over the window), and device ms per step by aten
    op and for the decode kernel (a CPU+CUDA profile of ``n // 2``
    steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for slot, p in enumerate(prompts[:eng.slots]):
        eng.admit(slot, p, CS_STEPS)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    prof.stop()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    m = n // 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(m):
            eng.step()
        torch.cuda.synchronize()
    by_op = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # the decode kernel is launched through ctypes, outside any aten op
        if us > 0 and (e.key.startswith("aten::")
                       or "decode_split_kernel" in e.key):
            key = ("decode_attention kernel" if "decode_split_kernel"
                   in e.key else e.key)
            by_op[key] = by_op.get(key, 0.0) + us / 1e3 / m
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    for slot in range(eng.slots):
        eng.release(slot)
    return {"host_ms_per_step": host_ms,
            "busy_share": busy / wall_us if spans else None,
            "device_events_per_step": len(spans) / n,
            "device_ms_per_step": sum(by_op.values()),
            "device_ms_by_op": by_op}


def cs_preempt_restore(eng, prompt, dev) -> dict:
    """One slot admitted, stepped, preempted and restored directly on the
    paged engine: its pages' bytes come back unchanged."""
    eng.admit(0, prompt, CS_STEPS)
    for _ in range(3):
        eng.step()
    held = eng.slot_pages(0).clone()
    blob = eng.preempt(0)
    eng.restore(0, blob)
    back = eng.slot_pages(0)
    same = held.shape == back.shape and torch.equal(
        held.contiguous().view(torch.uint8), back.contiguous().view(
            torch.uint8))
    eng.release(0)
    if not same:
        fail("paged engine: preempt -> restore changed the slot's pages")
    return {"pages": int(held.shape[2]), "bytes": held.numel()
            * held.element_size(), "byte_exact": True}


TS_CAPS = ("appsrc name=in caps=other/tensors,format=static,"
           "dimensions=3:224:224:1,types=uint8 ")


def ts_frames() -> list:
    rng = np.random.default_rng(7)
    return [[rng.integers(0, 256, (1, 224, 224, 3)).astype(np.uint8)
             for _ in range(TS_FRAMES)] for _ in range(2)]


def ts_lockstep(key: str, frames: list) -> list:
    """Two ``tensor_serving shared-key=<key>`` pipelines fed in lockstep
    (frame k of both streams, then wait for both outputs); returns each
    pipeline's output buffers."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    line = (TS_CAPS + f"! tensor_serving framework=torch model={TS_MODEL} "
            f"shared-key={key} bucket-sizes=1,2,4,8 ! tensor_sink name=out")
    pipes = [parse_launch(line) for _ in range(2)]
    got = [[], []]
    for i, p in enumerate(pipes):
        p.get("out").connect(got[i].append)
        p.play()
    try:
        for k in range(TS_FRAMES):   # lockstep: frame k of both streams
            for i in range(2):
                pipes[i].get("in").push_buffer(frames[i][k])
            deadline = time.monotonic() + 120
            while min(len(g) for g in got) <= k:
                if time.monotonic() > deadline:
                    fail(f"tensor_serving: frame {k} did not come out")
                time.sleep(0.0005)
        for p in pipes:
            p.get("in").end_of_stream()
        for p in pipes:
            msg = p.wait(timeout=120)
            if msg.type is not MessageType.EOS:
                fail(f"tensor_serving pipeline: {msg}")
    finally:
        for p in pipes:
            p.stop()
    return got


def cs_tensor_serving(dev: torch.device) -> dict:
    """(e): two pipelines sharing one scheduler, against tensor_filter."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    frames = ts_frames()
    got = ts_lockstep("mnet", frames)
    # the same frames one at a time through tensor_filter
    ref = parse_launch(TS_CAPS + f"! tensor_filter framework=torch "
                       f"model={TS_MODEL} ! tensor_sink name=out")
    want = []
    ref.get("out").connect(want.append)
    ref.play()
    try:
        for i in range(2):
            for f in frames[i]:
                ref.get("in").push_buffer(f)
        ref.get("in").end_of_stream()
        if ref.wait(timeout=120).type is not MessageType.EOS:
            fail("tensor_filter reference pipeline did not reach EOS")
    finally:
        ref.stop()
    served = [b for g in got for b in g]
    if len(served) != 2 * TS_FRAMES or len(want) != 2 * TS_FRAMES:
        fail(f"tensor_serving: {len(served)} outputs, tensor_filter "
             f"{len(want)}, expected {2 * TS_FRAMES}")
    worst, ties = 0.0, []
    for i, (a, b) in enumerate(zip(served, want)):
        la, lb = a.tensors[0], b.tensors[0]
        if not (la.is_cuda and tuple(la.shape) == (1, 1001)):
            fail(f"tensor_serving frame {i}: logits {tuple(la.shape)} on "
                 f"{la.device}")
        worst = max(worst, (la - lb).abs().max().item())
        if int(la.argmax()) != int(lb.argmax()):
            top = torch.topk(lb[0].float(), 2).values
            margin = float(top[0] - top[1])
            if not margin < MB_BF16_ATOL:
                fail(f"tensor_serving frame {i}: label {int(la.argmax())}, "
                     f"tensor_filter's {int(lb.argmax())} (margin {margin})")
            ties.append({"frame": i, "margin": margin})
    if worst > MB_BF16_ATOL:
        fail(f"tensor_serving logits differ from tensor_filter's by {worst} "
             f"> {MB_BF16_ATOL}")
    ids = [[b.meta["serving"]["batch_id"] for b in g] for g in got]
    rows = {}
    for bid in ids[0] + ids[1]:
        rows[bid] = rows.get(bid, 0) + 1
    mixed = len(set(ids[0]) & set(ids[1]))
    if mixed < 1:
        fail("tensor_serving: no batch mixed the two streams")
    sizes = {}
    for r in rows.values():
        sizes[r] = sizes.get(r, 0) + 1
    r = {"frames": len(served), "batches": len(rows),
         "mixed_batches": mixed, "batch_rows": sizes,
         "logits_max_abs_err_vs_filter": worst, "label_ties": ties}
    print(f"tensor_serving: 2 pipelines x {TS_FRAMES} frames, shared-key "
          f"mnet: {len(rows)} batches, {mixed} mixing both streams, rows "
          f"per batch {sizes}; labels equal tensor_filter's argmax "
          f"({len(ties)} near ties), logits max |diff| {worst:.3e} "
          f"(atol {MB_BF16_ATOL})")
    return r


def phase_continuous(report: dict, dev: torch.device) -> dict:
    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.lm_serving import base
    from nnstreamer_tpu_torch.serving import (
        DecodeScheduler,
        NgramDraft,
        SpeculativeLMEngine,
    )

    # every number of this phase stands beside the card it ran on
    print(f"continuous serving on {report['device']} (name, power limit)")
    r = {"slot_kernel": cs_slot_kernel(dev)}
    cfg = base._cfg_serve
    layers = cfg.layers
    prompts = cs_prompts(CS_REQUESTS, cfg.vocab)

    # (b) the dense engine behind the scheduler
    eng = base.make_continuous(slots=CS_SLOTS, device=dev)
    params = eng.params
    sched = DecodeScheduler(eng, name="cs-dense")
    try:
        reset_launches()
        run = cs_run(sched, prompts, CS_STEPS)
        launches = read_launches()
        dense = cs_engine_stats("continuous dense", sched, run["wall_s"],
                                CS_REQUESTS * CS_STEPS)
        steps = sched.metrics_snapshot()["decode_steps"]
    finally:
        sched.close()
    want_l = {"decode_attention": layers * steps,
              "flash_attention": layers * CS_REQUESTS}
    if launches != want_l:
        fail(f"continuous dense: kernel launches {launches}, expected "
             f"{want_l} ({layers} layers x {steps} decode steps, x "
             f"{CS_REQUESTS} admits for flash)")
    gen = make_generate(cfg)
    with torch.inference_mode():
        alone = [gen(params, torch.from_numpy(p[None]).to(dev),
                     CS_STEPS)[0, len(p):].tolist() for p in prompts]
    dense["ties_vs_batch1"] = cs_compare(
        "continuous dense vs batch-1", run["tokens"], alone, prompts, cfg,
        params, dev)
    dense.update(launches=launches, cache_bytes=eng.cache_bytes,
                 param_bytes=eng.param_bytes)
    print(f"continuous dense: {CS_REQUESTS} requests equal batch-1 "
          f"make_generate; kernel launches {launches} ({layers} x {steps} "
          f"steps); cache {eng.cache_bytes} bytes, params "
          f"{eng.param_bytes} bytes")
    dense["step_breakdown"] = bd = cs_step_breakdown(eng, prompts)
    top = ", ".join(f"{k} {v:.4f}" for k, v in
                    list(bd["device_ms_by_op"].items())[:6])
    print(f"continuous dense step, {CS_SLOTS} slots active: host "
          f"{bd['host_ms_per_step']:.3f} ms a step; card busy "
          + ("not measured (no device activity in the trace)"
             if bd["busy_share"] is None else f"{100 * bd['busy_share']:.1f}%")
          + f", {bd['device_events_per_step']:.1f} device events a step; "
          f"device ms a step by op: {top} of "
          f"{bd['device_ms_per_step']:.4f} in all")
    r["dense"] = dense
    dense_tokens = run["tokens"]
    del eng, alone

    # (c) the paged engine: the same requests plus a shared prefix
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab, CS_PREFIX).astype(np.int32)
    # the first is the prefix alone: its prefill registers the prefix's
    # full pages under exactly those tokens, which the others start with
    lo, hi = CS_SHARED_TAIL
    shared = [prefix] + [np.concatenate([prefix, rng.integers(
        0, cfg.vocab, int(rng.integers(lo, hi + 1))).astype(np.int32)])
        for _ in range(CS_SHARED - 1)]
    peng = base.make_continuous(slots=CS_SLOTS, paged=True,
                                page_size=CS_PAGE, chunk=CS_CHUNK,
                                share_prefixes=True, device=dev)
    r["preempt_restore"] = cs_preempt_restore(peng, prompts[0], dev)
    print(f"paged preempt -> restore: {r['preempt_restore']['pages']} pages "
          f"({r['preempt_restore']['bytes']} bytes) byte-exact on the card")
    sched = DecodeScheduler(peng, name="cs-paged")
    peak_shared = [0]

    def sample():
        peak_shared[0] = max(peak_shared[0],
                             peng.pool.stats()["pages_shared"])

    try:
        reset_launches()
        prun = cs_run(sched, prompts, CS_STEPS, on_wait=sample)
        paged_launches = read_launches()
        paged = cs_engine_stats("continuous paged", sched, prun["wall_s"],
                                CS_REQUESTS * CS_STEPS)
        # the shared-prefix requests: the first registers the prefix's
        # pages when its prefill completes, the rest then map them
        t0 = time.perf_counter()
        first = sched.submit(shared[0], steps=CS_STEPS)
        while not first.tokens and not first.done():
            time.sleep(0.001)
        rest = [sched.submit(p, steps=CS_STEPS) for p in shared[1:]]
        while not all(q.done() for q in [first] + rest):
            sample()
            time.sleep(0.002)
        shared_s = time.perf_counter() - t0
        prun["tokens"] += [q.result(1)[0].tolist() for q in [first] + rest]
        pool = peng.pool.stats()
    finally:
        sched.close()
    paged["shared_prefix_tokens_per_s"] = CS_SHARED * CS_STEPS / shared_s
    if pool["prefix_hits_total"] < CS_SHARED - 1:
        fail(f"paged engine: {pool['prefix_hits_total']} prefix hits for "
             f"{CS_SHARED - 1} requests sharing a registered prefix")
    paged["ties_vs_dense"] = cs_compare(
        "continuous paged vs dense", prun["tokens"][:CS_REQUESTS],
        dense_tokens, prompts, cfg, params, dev)
    with torch.inference_mode():
        shared_alone = [gen(params, torch.from_numpy(p[None]).to(dev),
                            CS_STEPS)[0, len(p):].tolist() for p in shared]
    paged["ties_shared_vs_batch1"] = cs_compare(
        "continuous paged, shared prefix, vs batch-1",
        prun["tokens"][CS_REQUESTS:], shared_alone, shared, cfg, params, dev)
    if not (peak_shared[0] > 0 and pool["prefix_hits_total"] > 0):
        fail(f"paged engine: no pages shared (peak {peak_shared[0]}, prefix "
             f"hits {pool['prefix_hits_total']})")
    paged.update(launches=paged_launches, pages_shared_peak=peak_shared[0],
                 prefix_hits=pool["prefix_hits_total"],
                 cow_copies=pool["cow_copies_total"],
                 cache_bytes=peng.cache_bytes)
    print(f"continuous paged: tokens equal the dense engine's and the "
          f"shared-prefix requests' batch-1 tokens; pages shared (peak) "
          f"{peak_shared[0]}, prefix hits {pool['prefix_hits_total']}, COW "
          f"copies {pool['cow_copies_total']}; the {CS_SHARED} shared-prefix "
          f"requests at {paged['shared_prefix_tokens_per_s']:.1f} tokens/s; "
          f"kernel launches {paged_launches} (its attention is "
          "gather-then-dense)")
    r["paged"] = paged

    # (d) speculative decode over the paged engine, n-gram draft
    spec = SpeculativeLMEngine(peng, NgramDraft(), k=CS_SPEC_K)
    sched = DecodeScheduler(spec, name="cs-spec")
    try:
        srun = cs_run(sched, prompts[:CS_SPEC_REQUESTS], CS_STEPS)
        sr = cs_engine_stats("continuous speculative", sched, srun["wall_s"],
                             CS_SPEC_REQUESTS * CS_STEPS)
    finally:
        sched.close()
    sr["ties_vs_target_only"] = cs_compare(
        "speculative vs target-only", srun["tokens"],
        prun["tokens"][:CS_SPEC_REQUESTS], prompts[:CS_SPEC_REQUESTS], cfg,
        params, dev)
    sr.update(acceptance_rate=spec.acceptance_rate(),
              rounds=spec.spec_rounds)
    print(f"continuous speculative (n-gram, k={CS_SPEC_K}): tokens equal "
          f"target-only decoding; acceptance rate "
          f"{spec.acceptance_rate():.4f} over {spec.spec_rounds} rounds")
    r["speculative"] = sr
    del peng, spec, params

    # (e) tensor_serving
    reset_launches()
    r["tensor_serving"] = cs_tensor_serving(dev)
    r["tensor_serving"]["launches"] = read_launches()
    report["continuous"] = r
    return r


# the zoo phase (11): the three lines of the reference's bench suite
# (tools/bench_suite.py:637-682) at 224×224×3, batch MB_BATCH, MB_WARM
# warm-up and MB_MEASURED measured batches, bf16 on the card
ZOO = {
    "ssd_mobilenet": ("nnstreamer_tpu_torch.models.ssd_mobilenet",
                      "mode=bounding_boxes option1=mobilenet-ssd-postprocess "
                      "option3=,30 option4=224:224"),
    "posenet": ("nnstreamer_tpu_torch.models.posenet",
                "mode=pose_estimation option1=224:224 option2=heatmap"),
    "deeplab": ("nnstreamer_tpu_torch.models.deeplab",
                "mode=image_segment option1=tflite-deeplab"),
}
ZOO_OUTPUTS = {"ssd_mobilenet": ("boxes", "scores"),
               "posenet": ("heatmaps",), "deeplab": ("logits",)}
# measured batches whose filter outputs the decoder gates decode again
ZOO_GATE_BATCHES = 2
# bf16 vs f32 per output: phase 8's MB_BF16_ATOL, except SSD's scores.
# Those are the sigmoid of 3135 x 91 class logits a frame that come
# straight out of a bf16 convolution, with no average over the map to
# shrink the rounding as MobileNet's global pool does. The port's bf16
# build on the CPU already differs from its f32 build by 5.5e-4 there
# (seed 0, 4 frames of mb_host_frames), above MB_BF16_ATOL; they are held
# to 2e-3, about 4x that gap, which a fault in the model (a wrong layer,
# a wrong weight layout) would exceed by far: the scores span 0.46-0.54.
ZOO_BF16_ATOL = {("ssd_mobilenet", "scores"): 2e-3}
# a candidate cap above SSD's 3135 anchors: nothing is cut before NMS
ZOO_NO_CAP = 4096


def zoo_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def zoo_model(name: str, dev: torch.device) -> dict:
    """Card float32 (cuDNN's TF32 flag on) vs the CPU's float32, and card
    bf16 vs card float32, on every output; the bf16 forward's time at
    batch MB_BATCH."""
    import importlib

    from nnstreamer_tpu_torch.models._blocks import make_u8_entry

    mod = importlib.import_module(ZOO[name][0])
    f32_entry = make_u8_entry(replace(mod.filter_model, compute_dtype="float32"))
    f32_card = f32_entry.make(dev)
    bf16_card = mod.filter_model_u8.make(dev)
    if bf16_card.dtype is not torch.bfloat16 or f32_card.dtype is not torch.float32:
        fail(f"{name}: compute dtypes {bf16_card.dtype} (auto on the card) "
             f"and {f32_card.dtype} (float32)")
    x = torch.from_numpy(mb_host_frames(MB_PARITY_FRAMES))
    cpu = zoo_tuple(f32_entry.make("cpu")(x))
    xd = x.to(dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        f32 = zoo_tuple(f32_card(xd))
        if not torch.backends.cudnn.allow_tf32:
            fail(f"{name}: the float32 forward left cuDNN's TF32 flag off")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    bf16 = zoo_tuple(bf16_card(xd))
    r = {}
    for out_name, c, f, b in zip(ZOO_OUTPUTS[name], cpu, f32, bf16):
        if not (f.is_cuda and b.is_cuda and f.dtype is b.dtype is torch.float32
                and f.shape == b.shape == c.shape
                and bool(torch.isfinite(f).all())
                and bool(torch.isfinite(b).all())):
            fail(f"{name} {out_name}: card outputs {f.dtype} "
                 f"{tuple(f.shape)} on {f.device}, {b.dtype} on {b.device}, "
                 f"CPU {tuple(c.shape)}")
        f, b = f.cpu(), b.cpu()
        err = (f - c).abs().max().item()
        cerr, cstd = mb_centred_err(f, c)
        bf_err = (b - f).abs().max().item()
        limit = ZOO_BF16_ATOL.get((name, out_name), MB_BF16_ATOL)
        r[out_name] = {"shape": list(f.shape),
                       "card_f32_vs_cpu_max_abs_err": err,
                       "card_f32_vs_cpu_centred_err": cerr,
                       "cpu_centred_std": cstd,
                       "max_abs": c.abs().max().item(),
                       "bf16_vs_f32_max_abs_err": bf_err,
                       "bf16_atol": limit}
        print(f"zoo {name} {out_name} {tuple(f.shape)} on {MB_PARITY_FRAMES} "
              f"frames: card f32 (cuDNN TF32 flag on) vs CPU max |err| "
              f"{err:.3e} (atol {MB_LOGIT_ATOL}), centred {cerr:.3e} vs "
              f"centred std {cstd:.3e} (share {MB_CENTRED_SHARE}); bf16 vs "
              f"f32 {bf_err:.3e} (atol {limit})")
        if not (err <= MB_LOGIT_ATOL and cerr <= MB_CENTRED_SHARE * cstd):
            fail(f"{name} {out_name}: card f32 differs from the CPU's: "
                 f"{r[out_name]}")
        if not bf_err <= limit:
            fail(f"{name} {out_name}: bf16 differs from f32 by {bf_err}")
    gen = torch.Generator(device=dev).manual_seed(4)
    batches = [(torch.randint(0, 127, (MB_BATCH, 224, 224, 3), generator=gen,
                              device=dev, dtype=torch.uint8),)
               for _ in range(2)]
    r["forward_ms_bfloat16"] = time_ms(bf16_card, batches, reps=5, inner=5,
                                       sleep_cycles=200_000_000)
    print(f"zoo {name} filter_model_u8 forward at batch {MB_BATCH}, bf16: "
          f"{r['forward_ms_bfloat16']:.4f} ms "
          f"({MB_BATCH * 1e3 / r['forward_ms_bfloat16']:.1f} frames/s)")
    return r


def zoo_decoded(buf) -> tuple:
    """A decoded buffer as comparable values: its bytes, and its
    detections (box, class), keypoints or class map."""
    meta = None
    if "detections" in buf.meta:
        meta = [(d["box"], d["class"]) for d in buf.meta["detections"]]
    elif "keypoints" in buf.meta:
        meta = [(k["x"], k["y"], k["score"], k["valid"])
                for k in buf.meta["keypoints"]]
    elif "class_map" in buf.meta:
        meta = np.asarray(buf.meta["class_map"]).tobytes()
    return bytes(np.ascontiguousarray(np.asarray(buf.tensors[0]))), meta


def zoo_decode(dec: str, bufs, fi: int) -> list:
    """``appsrc ! tensor_decoder <dec> frames-in=<fi> ! tensor_sink`` over
    ``bufs`` (card tensors: the reduce path; numpy: the host path)."""
    from nnstreamer_tpu_torch.core import Buffer, MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    first = bufs[0]
    dims = ".".join(":".join(str(d) for d in reversed(t.shape)) for t in first)
    types = ",".join("float32" for _ in first)
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"num_tensors={len(first)},dimensions={dims},types={types} "
        f"! tensor_decoder {dec} frames-in={fi} name=d "
        "! tensor_sink name=out max-stored=0")
    got = []
    pipe.get("out").connect(lambda buf: got.append(zoo_decoded(buf)))
    pipe.play()
    try:
        for b in bufs:
            pipe.get("in").push_buffer(Buffer(list(b)))
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"decoder {dec}: {msg}")
    return got


def zoo_line(name: str) -> tuple:
    """Drive one zoo line at full width; the filter is tapped for its host
    time and the outputs of ZOO_GATE_BATCHES measured batches, the decoder
    for its host time and any host decode, the sink for the decoded
    buffers of those batches. Returns (results, tapped outputs, their
    decoded buffers)."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n_batches, b = MB_WARM + MB_MEASURED, MB_BATCH
    model = f"{ZOO[name][0]}:filter_model_u8"
    line = (MB_HEAD.format(n=n_batches * b, b=b)
            + f"! tensor_filter framework=torch model={model} "
            "sync-invoke=false name=f ! queue max-size-buffers=8 "
            f"! tensor_decoder {ZOO[name][1]} frames-in={b} name=d "
            "! tensor_sink name=out max-stored=1")
    pipe = parse_launch(line)
    filt, dec = pipe.get("f"), pipe.get("d")
    gate = range(MB_WARM, MB_WARM + ZOO_GATE_BATCHES)
    tapped_out, devices, filter_s, decoder_s, host_decodes = {}, set(), [], [], []
    transform = filt.transform

    def tapped(buf):
        t0 = time.perf_counter()
        out = transform(buf)
        filter_s.append(time.perf_counter() - t0)
        k = len(filter_s) - 1
        devices.add((str(filt.backend_device),)
                    + tuple(str(t.device) for t in out.tensors))
        if k in gate:
            tapped_out[k] = list(out.tensors)
        return out

    filt.transform = tapped
    host_decode = dec.decoder.decode

    def counted_decode(buf, info):
        host_decodes.append(1)
        return host_decode(buf, info)

    dec.decoder.decode = counted_decode
    chain = dec.chain

    def timed_chain(pad, buf):
        t0 = time.perf_counter()
        chain(pad, buf)
        decoder_s.append(time.perf_counter() - t0)

    dec.chain = timed_chain
    times, decoded = [], {}

    def on_data(buf):
        i = len(times)
        times.append(time.perf_counter())
        if i // b in gate:
            decoded[i] = zoo_decoded(buf)

    pipe.get("out").connect(on_data)
    reset_launches()
    pipe.play()
    try:
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    launches = read_launches()
    if msg.type is not MessageType.EOS:
        fail(f"zoo {name} line: {msg}")
    want_dev = ("cuda:0",) * (1 + len(ZOO_OUTPUTS[name]))
    if devices != {want_dev}:
        fail(f"zoo {name}: filter (backend device, output devices) "
             f"{sorted(devices)}, expected cuda:0 for all")
    if len(filter_s) != n_batches or len(times) != n_batches * b:
        fail(f"zoo {name}: {len(filter_s)} filter invocations and "
             f"{len(times)} decoded buffers for {n_batches} batches of {b}")
    if host_decodes:
        fail(f"zoo {name}: the decoder decoded {len(host_decodes)} frames on "
             "the host instead of reducing the batch on the card")
    ends = times[b - 1::b]
    steady = slice(MB_WARM, None)
    first = tapped_out[gate[0]]
    reduced = dec._get_reduce()(first)
    r = {"frames_per_s": MB_MEASURED * b / (ends[-1] - ends[MB_WARM - 1]),
         "batch_ms_median": 1e3 * statistics.median(
             y - x for x, y in zip(ends[MB_WARM - 1:], ends[MB_WARM:])),
         # host time of the filter's transform per batch (the H2D copy and
         # the forward's launches) and of the decoder's chain (the reduce's
         # launches, its one pull, which waits for the forward, and the
         # per-frame host finish)
         "filter_host_ms_median": 1e3 * statistics.median(filter_s[steady]),
         "decoder_host_ms_median": 1e3 * statistics.median(decoder_s[steady]),
         "d2h_bytes_per_batch_without_reduce": sum(
             t.numel() * t.element_size() for t in first),
         "d2h_bytes_per_batch_with_reduce": sum(
             t.numel() * t.element_size() for t in reduced),
         "launches": launches}
    if name == "ssd_mobilenet":
        n_above = reduced[3].cpu()
        r["n_above_per_frame"] = {"min": int(n_above.min()),
                                  "max": int(n_above.max())}
        r["kept_per_frame"] = int(reduced[0].shape[1])
        r["detections_per_frame_mean"] = float(np.mean(
            [len(decoded[i][1]) for i in decoded]))
    return r, tapped_out, decoded


def zoo_gates(name: str, tapped_out: dict, decoded: dict) -> dict:
    """The tapped card outputs decoded per frame on the host (frames-in=1,
    the tensors pulled first) against the batched reduce on the card:
    image_segment and pose_estimation against the line's own decoded
    buffers; bounding_boxes, whose line caps the candidates at 256,
    through the reduce again with the cap above the anchor count."""
    dec, b = ZOO[name][1], MB_BATCH
    batches = [tapped_out[k] for k in sorted(tapped_out)]
    frames = []
    for outs in batches:
        host = [t.cpu().numpy() for t in outs]
        frames += [[a[f:f + 1] for a in host] for f in range(b)]
    host_dec = zoo_decode(dec, frames, 1)
    if name == "ssd_mobilenet":
        card = zoo_decode(f"{dec} option10={ZOO_NO_CAP}", batches, b)
        capped = [decoded[i] for i in sorted(decoded)]
        r = {"frames": len(host_dec),
             "capped_frames_differing": sum(c != h for c, h in
                                            zip(capped, host_dec))}
    else:
        card = [decoded[i] for i in sorted(decoded)]
        r = {"frames": len(host_dec)}
    if len(card) != len(host_dec) or card != host_dec:
        bad = sum(c != h for c, h in zip(card, host_dec))
        fail(f"zoo {name}: the reduce on the card and the host decode "
             f"differ on {bad} of {len(host_dec)} frames")
    r["equal"] = True
    return r


def phase_zoo(report: dict, dev: torch.device) -> dict:
    print(f"zoo on {report['device']} (name, power limit)")
    z = {}
    for name, (module, dec) in ZOO.items():
        r = {"model": zoo_model(name, dev)}
        res, tapped_out, decoded = zoo_line(name)
        r["line"] = res
        print(f"zoo {name} line: {res['frames_per_s']:.1f} frames/s "
              f"({MB_MEASURED} batches of {MB_BATCH} after {MB_WARM} warm-up; "
              f"median batch {res['batch_ms_median']:.3f} ms; host per batch: "
              f"filter {res['filter_host_ms_median']:.3f} ms, decoder "
              f"{res['decoder_host_ms_median']:.3f} ms); device->host bytes "
              f"per batch {res['d2h_bytes_per_batch_with_reduce']} with the "
              f"reduce, {res['d2h_bytes_per_batch_without_reduce']} without; "
              f"kernel launches {res['launches']} (this path runs no "
              "hand-written kernel)")
        if name == "ssd_mobilenet":
            print(f"zoo {name} at the default cap: {res['n_above_per_frame']}"
                  f" candidates above the threshold a frame, "
                  f"{res['kept_per_frame']} kept for NMS, "
                  f"{res['detections_per_frame_mean']:.2f} detections a "
                  "frame after it")
        r["gates"] = zoo_gates(name, tapped_out, decoded)
        del tapped_out
        print(f"zoo {name} gate: {r['gates']['frames']} frames decoded on the "
              "host from the pulled outputs equal the batched reduce on the "
              "card" + (f" at option10={ZOO_NO_CAP} ((box, class) lists and "
                        "overlay bytes); at the line's cap of 256, "
                        f"{r['gates']['capped_frames_differing']} frames "
                        "differ from the host decode"
                        if name == "ssd_mobilenet" else " (bytes)"))
        r["latency_batch1"] = frame_latency(
            f"zoo {name}", f"{module}:filter_model_u8", dec,
            lambda buf: buf.tensors and buf.meta.keys() & {
                "detections", "keypoints", "class_map"})
        print(f"zoo {name} batch-1 push-to-decoded latency: p50 "
              f"{r['latency_batch1']['p50_ms']:.3f} ms, p90 "
              f"{r['latency_batch1']['p90_ms']:.3f} ms over {MB_P50_FRAMES} "
              "frames")
        z[name] = r
        torch.cuda.empty_cache()
    report["zoo"] = z
    return z


# phase 12: the observability plane over the LM and MobileNet lines
OBS_TRACERS = ("proctime", "framerate", "interlatency", "queuelevel",
               "chrometrace")
OBS_DIR = ROOT / "chiprun_out" / "obs"
# the two hand kernels' CUDA names (csrc/*.cu), matched by substring in
# the profiler trace
OBS_KERNELS = {"decode_attention": "decode_split_kernel",
               "flash_attention": "flash_attention_kernel"}
# the NaN line: batches of 64 frames through the MobileNet filter into
# tensor_fault, which poisons 1/16 of each float tensor from batch 2 on
OBS_NAN_BATCHES, OBS_NAN_AT = 4, 2
# overhead states, each run twice in the order below (ABCCBA); "on" taps
# at quality.start's default cadence; the LM line serves OBS_LM_ROUNDS
# copies of phase 4's requests a run (tokens/s over requests 2..n)
OBS_STATES = ("no_hook", "checks", "on", "on", "checks", "no_hook")
OBS_SAMPLE_EVERY = 8
OBS_LM_ROUNDS = 3
# traces of the LM line that --only trace-loss takes
OBS_LOSS_TRACES = 40
# runs of the LM line until one trace holds every hand-kernel launch
# (CUPTI loses hand-kernel records in some traces on the H100;
# --only trace-loss counts them)
OBS_TRACE_ATTEMPTS = 10


def obs_hooks_on(sample_every: int, tracers=OBS_TRACERS) -> None:
    """Every hook of the obs plane on: the tracers, the profiler, the
    quality taps (one reduce every ``sample_every`` buffers per edge), the
    memory accountant and request-scoped tracing."""
    from nnstreamer_tpu_torch.obs import context, memory, profile, quality
    from nnstreamer_tpu_torch.utils import trace

    trace.install_tracers(list(tracers))
    profile.start()
    quality.start(sample_every=sample_every)
    memory.start()
    context.enable_tracing()


def obs_hooks_off() -> None:
    """Back to the one-global-check path; the recorded data is dropped."""
    from nnstreamer_tpu_torch.obs import context, memory, profile, quality
    from nnstreamer_tpu_torch.utils import trace

    trace.uninstall_tracers()
    for mod in (profile, quality, memory):
        mod.stop()
        mod.reset()
    context.disable_tracing()
    context.reset()


def obs_wait(cond, what: str, timeout: float = 600.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"obs: timed out waiting for {what}")
        time.sleep(0.001)


def obs_f32_moments_ok(got, want, a: np.ndarray) -> bool:
    """The CPU tests' float32 tolerance: sum within 1e-5 of the sum of
    |v|, sum of squares within rtol 1e-5, min and max exact."""
    fin = np.abs(a[np.isfinite(a)].astype(np.float64)).sum()
    return (abs(got[0] - want[0]) <= 1e-5 * max(fin, 1e-30)
            and abs(got[1] - want[1]) <= 1e-5 * max(abs(want[1]), 1e-30)
            and got[2] == want[2] and got[3] == want[3])


def obs_trace_kernels(path: str) -> dict:
    """Device events of the two hand kernels in a torch.profiler chrome
    trace: count and median ms each."""
    doc = json.loads(Path(path).read_text())
    durs = {k: [] for k in OBS_KERNELS}
    n_kernel = 0
    for e in doc.get("traceEvents", []):
        if e.get("cat") != "kernel":
            continue
        n_kernel += 1
        for k, sub in OBS_KERNELS.items():
            if sub in e.get("name", ""):
                durs[k].append(float(e["dur"]) / 1e3)
    return {"device_kernel_events": n_kernel,
            **{k: {"events": len(v),
                   "median_ms": statistics.median(v) if v else None}
               for k, v in durs.items()}}


def obs_lm_line(prompts, want, phase3: Optional[dict]) -> dict:
    """(a) the LM filter line at base, f32, every hook on; request 3
    inside trace.torch_trace. ``phase3`` (phase 3's timings) is printed
    beside the trace's kernel medians where given."""
    import inspect
    import os
    import shutil
    import tempfile

    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.models.lm_serving import base
    from nnstreamer_tpu_torch.obs import memory as obs_memory
    from nnstreamer_tpu_torch.obs import profile as obs_profile
    from nnstreamer_tpu_torch.obs import quality as obs_quality
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.utils import trace

    OBS_DIR.mkdir(parents=True, exist_ok=True)
    for old in OBS_DIR.glob("nns_trace-*.json"):
        old.unlink()
    os.environ["NNS_TRACE_DIR"] = str(OBS_DIR)
    obs_hooks_on(sample_every=1)
    pipe = parse_launch(lm_filter_line(prompts))
    outs, t_out = [], []

    def on_data(buf):
        torch.cuda.synchronize()
        t_out.append(time.perf_counter())
        outs.append(buf.tensors[0])

    pipe.get("out").connect(on_data)
    logdir = tempfile.mkdtemp(prefix="nns_torch_trace_")
    reset_launches()
    try:
        pipe.play()
        src = pipe.get("in")
        for p in prompts[:-1]:
            src.push_buffer(p)
        obs_wait(lambda: len(outs) == REQUESTS - 1, "LM requests 1-2")
        before = read_launches()
        with trace.torch_trace(logdir) as prof:
            src.push_buffer(prompts[-1])
            obs_wait(lambda: len(outs) == REQUESTS, "LM request 3")
        traced = {k: v - before[k] for k, v in read_launches().items()}
        devices = obs_memory.sample_devices()
        params = inspect.getclosurevars(
            pipe.get("f").backend._fn).nonlocals["params"]
        param_bytes = obs_memory.tree_nbytes(params)
        src.end_of_stream()
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    launches = read_launches()
    tracer_res = trace.trace_results()
    prof_snap = obs_profile.snapshot()
    cells = obs_quality.accountant().stages()
    mem = obs_memory.accountant().stages()
    chrome = [t for t in trace._tracers
              if isinstance(t, trace.ChromeTraceTracer)]
    chrome_path = chrome[0].save() if chrome else None
    obs_hooks_off()
    kern = obs_trace_kernels(prof.trace_path)
    shutil.rmtree(logdir, ignore_errors=True)

    if msg.type is not MessageType.EOS:
        fail(f"obs LM line: {msg}")
    got = [o.cpu().numpy() for o in outs]
    if len(got) != REQUESTS or any(not np.array_equal(a, b)
                                   for a, b in zip(got, want)):
        fail("obs LM line: tokens under every hook differ from phase 4's "
             "float32 tokens")
    check_launches("obs LM line", launches, base.cfg.layers)
    lost = prof.lost_kernel_records
    for k, sub in OBS_KERNELS.items():
        if (not traced[k] or kern[k]["events"] > traced[k]
                or (kern[k]["events"] < traced[k] and not lost)):
            fail(f"obs LM line: the profiler trace holds {kern[k]['events']} "
                 f"'{sub}' device events for request 3, the launch counter "
                 f"{traced[k]} ({lost} launches without a device record)")
    elements = [n for n, el in pipe.elements.items()
                if el not in pipe.sources]
    proctime = tracer_res.get("proctime", {})
    series = prof_snap["durations"].get("element", {})
    for n in elements:
        rows = (proctime.get(n, {}).get("buffers"),
                series.get(f"{pipe.name}:{n}", {}).get("count"))
        if rows != (REQUESTS, REQUESTS):
            fail(f"obs LM line: element {n}: proctime buffers / profiler "
                 f"count {rows}, expected {REQUESTS}")
    if chrome_path is None:
        fail("obs LM line: the chrometrace tracer wrote nothing")
    spans = json.loads(Path(chrome_path).read_text())["traceEvents"]
    if sorted(e["name"] for e in spans) != sorted(elements * REQUESTS):
        fail(f"obs LM line: chrome trace spans "
             f"{sorted(e['name'] for e in spans)}")
    edges = {f"{pipe.name}:{n}" for n in elements}
    if set(cells) != edges or any(
            c["nan"] or c["inf"] or c["buffers"] != REQUESTS
            for c in cells.values()):
        fail(f"obs LM line: health cells {cells}")
    stage = mem.get(f"{pipe.name}:f", {})
    if stage.get("param_bytes") != param_bytes:
        fail(f"obs LM line: accountant param_bytes "
             f"{stage.get('param_bytes')}, tree_nbytes of the model "
             f"{param_bytes}")
    free, total = torch.cuda.mem_get_info(0)
    dev0 = next((d for d in devices if d["device"] == "cuda:0"), None)
    if (dev0 is None or dev0["budget_bytes"] != total
            or dev0["bytes_in_use"] < param_bytes):
        fail(f"obs LM line: sample_devices {devices}, card total {total}, "
             f"param bytes {param_bytes}")
    gen_tokens = 8 * STEPS
    r = {"launches": launches, "request3_launches": traced,
         "tokens_per_s_requests_1_2": gen_tokens / (t_out[1] - t_out[0]),
         "trace": kern, "trace_lost_kernel_records": lost,
         "trace_complete": all(kern[k]["events"] == traced[k]
                               for k in OBS_KERNELS),
         "param_bytes": param_bytes, "memory_stage": stage,
         "device": dev0, "proctime": proctime,
         "interlatency": tracer_res.get("interlatency"),
         "chrome_trace": chrome_path,
         "health": {k: {f: c[f] for f in ("buffers", "elems", "nan", "inf",
                                          "min", "max")}
                    for k, c in cells.items()}}
    for k in OBS_KERNELS:
        if not r["trace_complete"]:
            print(f"obs {k}: {kern[k]['events']} device events in request 3 "
                  f"of {traced[k]} launches; CUPTI delivered no device "
                  f"record for {lost} launches of the request")
            continue
        vs = (f" vs phase 3's {phase3[k][str(torch.float32)]['ms']:.6f} ms"
              if phase3 else "")
        print(f"obs {k}: {kern[k]['events']} device events in request 3 "
              f"(= launches), median {kern[k]['median_ms']:.6f} ms in the "
              f"trace{vs}")
    print(f"obs LM line: tokens equal phase 4's under every hook; launches "
          f"{launches}; param_bytes {param_bytes} (measured temp "
          f"{stage.get('temp_bytes')} B); cuda:0 in use "
          f"{dev0['bytes_in_use']} of {total} B")
    return r


def obs_serving_line() -> dict:
    """(b) phase 10e's tensor_serving MobileNet line (bf16) with the taps
    on: each sampled card reduce (batch outputs and the buffers into the
    sinks) against the host reduce of the same output pulled afterwards;
    the tap's transfers; the request series."""
    from nnstreamer_tpu_torch.analysis import sanitizer as san
    from nnstreamer_tpu_torch.obs import profile as obs_profile
    from nnstreamer_tpu_torch.obs import quality as obs_quality

    sampled = []
    reduce_any = obs_quality._reduce_any

    def capture(t):
        r = reduce_any(t)
        if r is not None and isinstance(t, torch.Tensor):
            sampled.append((t, r))
        return r

    obs_hooks_on(sample_every=1, tracers=())
    san.enable_xfercheck()
    obs_quality._reduce_any = capture
    try:
        got = ts_lockstep("mnet-obs", ts_frames())
    finally:
        obs_quality._reduce_any = reduce_any
    xfer = [row for row in san.xfer_transfers()
            if row["stage"] == "quality:reduce"]
    san.disable_xfercheck()
    san.reset_xfercheck()
    cells = obs_quality.accountant().stages()
    reqs = {n: ws.snapshot() for n, ws in
            obs_profile.default_profiler._requests.items()}
    obs_hooks_off()

    serving = {n: c for n, c in cells.items() if c["kind"] == "serving"}
    batches = {b.meta["serving"]["batch_id"] for g in got for b in g}
    if len(serving) != 1:
        fail(f"obs serving: serving health cells {sorted(serving)}")
    name, cell = next(iter(serving.items()))
    # every batch output (the serving tap) and every output buffer (the
    # pad tap into each sink) was reduced on the card
    if cell["buffers"] != len(batches) or \
            len(sampled) != len(batches) + 2 * TS_FRAMES:
        fail(f"obs serving: {cell['buffers']} sampled batches of "
             f"{len(batches)}, {len(sampled)} card reduces")
    if any(not t.is_cuda for t, _ in sampled):
        fail("obs serving: a sampled output was not on the card")
    worst = 0.0
    for t, (elems, ivec, fvec, counts) in sampled:
        host = t.cpu().numpy()
        w_elems, w_ivec, w_fvec, w_counts = obs_quality._reduce_np(host)
        if (elems != w_elems or not np.array_equal(ivec, w_ivec)
                or not np.array_equal(counts, w_counts)):
            fail(f"obs serving: the card reduce of a {tuple(t.shape)} "
                 f"{t.dtype} output differs from the host reduce: "
                 f"{ivec} vs {w_ivec}")
        if not obs_f32_moments_ok(fvec, w_fvec, host):
            fail(f"obs serving: card moments {fvec} vs host {w_fvec}")
        worst = max(worst, abs(fvec[0] - w_fvec[0]))
    per_sample = [row["bytes"] / row["count"] for row in xfer]
    if not per_sample or max(per_sample) > 1024:
        fail(f"obs serving: the tap's device->host transfers {xfer}")
    req = reqs.get(name, {})
    if req.get("count") != 2 * TS_FRAMES or req.get("errors"):
        fail(f"obs serving: request series {name}: {req}, expected "
             f"{2 * TS_FRAMES} requests")
    print(f"obs serving: {len(sampled)} outputs of {name} reduced on the "
          f"card = the host reduce (counts, histogram exact; sum within "
          f"{worst:.3e}); {max(per_sample, default=0):.0f} B pulled a "
          f"sample; request "
          f"series counts {req['count']}")
    return {"series": name, "sampled": len(sampled),
            "dtype": str(sampled[0][0].dtype),
            "sum_max_abs_diff": worst, "d2h_bytes_per_sample": per_sample,
            "requests": req, "cell": {f: cell[f] for f in (
                "buffers", "elems", "nan", "inf", "min", "max")}}


def obs_nan_line() -> dict:
    """(c) NaN detection on the card: the MobileNet filter's bf16 line
    into tensor_fault nan-at-buffer=2."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.obs import flight
    from nnstreamer_tpu_torch.obs import quality as obs_quality
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    line = (MB_HEAD.format(n=OBS_NAN_BATCHES * MB_BATCH, b=MB_BATCH)
            + MB_FILTER + f"! tensor_fault name=flt "
            f"nan-at-buffer={OBS_NAN_AT} ! tensor_sink name=out "
            f"max-stored={OBS_NAN_BATCHES}")
    seq0 = max((e["seq"] for e in flight.dump()), default=-1)
    obs_quality.start(sample_every=1)
    pipe = parse_launch(line)
    outs = []
    pipe.get("out").connect(lambda b: outs.append(
        b.as_numpy().tensors[0]))
    pipe.play()
    try:
        msg = pipe.wait(timeout=300)
    finally:
        pipe.stop()
    cells = obs_quality.accountant().stages()
    worst = obs_quality.worst_score()
    obs_hooks_off()
    if msg.type is not MessageType.EOS or len(outs) != OBS_NAN_BATCHES:
        fail(f"obs NaN line: {msg}, {len(outs)} batches")
    edge = f"{pipe.name}:out"
    events = [e for e in flight.dump(category="quality")
              if e["seq"] > seq0 and e["name"] == "nonfinite"]
    span = MB_BATCH * 1001 // 16
    if [e["data"]["stage"] for e in events] != [edge] \
            or events[0]["data"]["nan"] != span:
        fail(f"obs NaN line: quality flight events {events}, expected one "
             f"at {edge} with the {span} NaN of one poisoned batch")
    if worst != obs_quality.NONFINITE_SCORE:
        fail(f"obs NaN line: worst_score {worst}")
    clean = [np.isfinite(np.asarray(o, np.float32)).all() for o in outs]
    if clean != [i < OBS_NAN_AT for i in range(OBS_NAN_BATCHES)]:
        fail(f"obs NaN line: finite batches {clean}")
    if cells[f"{pipe.name}:flt"]["nan"] or cells[edge]["nan"] != \
            span * (OBS_NAN_BATCHES - OBS_NAN_AT):
        fail(f"obs NaN line: health cells {cells}")
    print(f"obs NaN line: one quality/nonfinite event at {edge} "
          f"({span} NaN, batch {OBS_NAN_AT}); batches 0-{OBS_NAN_AT - 1} "
          f"finite; worst_score {worst}")
    return {"edge": edge, "event": events[0]["data"], "worst_score": worst,
            "nan_per_edge": {k: c["nan"] for k, c in cells.items()}}


def obs_overhead(prompts) -> dict:
    """(d) the LM filter line's tokens/s and the MobileNet host line's
    frames/s with Pad.push's trace check removed (``no_hook``), as
    shipped with every hook off (``checks``: one module-global check
    each), and with every hook on (``on``: the five tracers, the
    profiler, the taps at their default cadence, the accountant and
    request tracing), in the order of OBS_STATES. No limit."""
    from nnstreamer_tpu_torch.runtime import pad as pad_mod
    from nnstreamer_tpu_torch.utils import trace

    OBS_DIR.mkdir(parents=True, exist_ok=True)
    shipped = pad_mod.Pad.push

    def push_no_hook(self, buf):
        assert self.direction is pad_mod.PadDirection.SRC
        peer = self.peer
        if peer is None:
            return
        peer.element._chain_guarded(peer, buf)

    out = {"lm_tokens_per_s": {}, "mobilenet_host_frames_per_s": {}}
    for state in OBS_STATES:
        if state == "no_hook":
            pad_mod.Pad.push = push_no_hook
        if state == "on":
            obs_hooks_on(OBS_SAMPLE_EVERY, tracers=OBS_TRACERS[:-1])
            trace.install_tracer(trace.ChromeTraceTracer(
                path=str(OBS_DIR / "overhead_chrometrace.json")))
        try:
            lm = serve("", list(prompts) * OBS_LM_ROUNDS)
            mb = mb_run_line("host", mb_lines()["host"])
        finally:
            pad_mod.Pad.push = shipped
            if state == "on":
                obs_hooks_off()
        t = lm["t_out"]
        tps = (len(t) - 1) * 8 * STEPS / (t[-1] - t[0])
        out["lm_tokens_per_s"].setdefault(state, []).append(tps)
        out["mobilenet_host_frames_per_s"].setdefault(state, []).append(
            mb["frames_per_s"])
        print(f"obs overhead {state}: LM {tps:.1f} tokens/s, MobileNet host "
              f"line {mb['frames_per_s']:.1f} frames/s")
    return out


def phase_obs(report: dict, prompts, filter_outs, phase3: dict) -> None:
    for attempt in range(1, OBS_TRACE_ATTEMPTS + 1):
        lm = obs_lm_line(prompts, filter_outs, phase3)
        if lm["trace_complete"]:
            break
        print(f"obs LM line: trace {attempt} of {OBS_TRACE_ATTEMPTS} lost "
              "hand-kernel records; the line runs again")
    else:
        fail(f"obs LM line: CUPTI lost hand-kernel records in all "
             f"{OBS_TRACE_ATTEMPTS} traces")
    lm["trace_attempts"] = attempt
    r = {"lm_line": lm,
         "serving_line": obs_serving_line(),
         "nan_line": obs_nan_line(),
         "overhead": obs_overhead(prompts)}
    report["obs"] = r


def phase_trace_loss(report: dict) -> None:
    """--only trace-loss: CUPTI's lost kernel records over
    OBS_LOSS_TRACES traces of the obs LM line (each run holds every gate
    of the line but the trace's hand-kernel count)."""
    phase_build(report)
    prompts, want = phase_slice(report)
    runs = []
    for _ in range(OBS_LOSS_TRACES):
        lm = obs_lm_line(prompts, want, None)
        runs.append({
            "lost": lm["trace_lost_kernel_records"],
            "kernel_events": lm["trace"]["device_kernel_events"],
            **{k: [lm["trace"][k]["events"], lm["request3_launches"][k]]
               for k in OBS_KERNELS}})
    r = {"traces": len(runs),
         "lossy": sum(x["lost"] > 0 for x in runs),
         "short_of_a_hand_kernel": sum(
             any(x[k][0] < x[k][1] for k in OBS_KERNELS) for x in runs),
         "without_kernel_records": sum(x["kernel_events"] == 0
                                       for x in runs),
         "runs": runs}
    print(f"trace-loss: of {r['traces']} traces of the obs LM line, "
          f"{r['lossy']} lost kernel records, {r['short_of_a_hand_kernel']} "
          f"lost hand-kernel records, {r['without_kernel_records']} hold no "
          "kernel record")
    report["trace-loss"] = r


# fusion and placement phase (ROADMAP A4): the 8-element device chain of
# nnstreamer_tpu's tools/microbench_overhead.py, the MobileNet-v2 line
# with its normalisation and filter in one segment, and place="auto" on
# the host line
FU_ADD = "tensor_transform mode=arithmetic option=add:1"
FU_CHAIN_BUFS, FU_CHAIN_PARITY = 2000, 64
FU_NORM = "typecast:float32,add:-127.5,div:127.5"
FU_MB_MODEL = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model"
FU_MB_LINE = (
    "tensor_src device=true pattern=random types=uint8 "
    "dimensions=3:224:224:{b} num-buffers={n} ! tensor_transform "
    f"mode=arithmetic option={FU_NORM} name=t ! tensor_filter "
    f"framework=torch model={FU_MB_MODEL} name=f ! queue ! tensor_sink "
    "name=out max-stored={n}")
FU_P50_LINE = (
    "appsrc name=in caps=other/tensors,format=static,"
    "dimensions=3:224:224:1,types=uint8 ! tensor_transform "
    f"mode=arithmetic option={FU_NORM} name=t ! tensor_filter "
    f"framework=torch model={FU_MB_MODEL} name=f ! tensor_sink name=out "
    "max-stored=1")
FU_PLACE_LINE = (
    "tensor_src num-buffers={n} dimensions=3:224:224:1 types=uint8 "
    "pattern=random ! tensor_aggregator frames-out={b} frames-dim=0 "
    f"concat=true ! tensor_transform mode=arithmetic option={FU_NORM} "
    f"name=t ! tensor_filter framework=torch model={FU_MB_MODEL} name=f "
    "! queue name=q ! tensor_sink name=out max-stored={k}")
# batches of the calibrating run (more than CALIBRATION_DISPATCHES) and of
# the two runs whose sink bytes are compared
FU_PLACE_BATCHES, FU_PLACE_CHECK = 56, 6


def fu_run(line: str, fuse, place=None, keep: bool = True,
           on_play=None):
    """Run a line to EOS; the sink's buffers (in order) and the pipeline.
    ``on_play(pipe)`` runs right after ``play()`` returns."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(line, fuse=fuse, place=place)
    outs = []
    if keep:
        pipe.get("out").connect(lambda buf: outs.append(buf.tensors[0]))
    pipe.play()
    try:
        if on_play is not None:
            on_play(pipe)
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"fusion: {line[:60]}... ended with {msg}")
    return pipe, outs


def fu_chain_line(n_elems: int, n_bufs: int, keep: int) -> str:
    chain = " ! ".join([FU_ADD] * n_elems)
    return (f"tensor_src device=true num-buffers={n_bufs} dimensions=16 "
            f"types=float32 pattern=counter ! {chain} ! tensor_sink "
            f"name=out max-stored={keep}")


def fu_chain_overhead() -> dict:
    """Host µs per buffer of 1- and 8-element device chains, fused and
    with fuse=False (FU_CHAIN_BUFS buffers a run, after one warm-up run
    each), and the 8-element chain's sink bytes in both modes."""
    res = {}
    for fuse in (True, False):
        key = "fused" if fuse else "unfused"
        us = {}
        for n_elems in (1, 8):
            line = fu_chain_line(n_elems, FU_CHAIN_BUFS, 1)
            fu_run(line, fuse, keep=False)          # warm-up
            t0 = time.perf_counter()
            pipe, _ = fu_run(line, fuse, keep=False)
            us[n_elems] = 1e6 * (time.perf_counter() - t0) / FU_CHAIN_BUFS
        segs = [dict(s.stats) for s in pipe.fused_segments]
        res[key] = {
            "us_per_buffer_1": us[1], "us_per_buffer_8": us[8],
            "us_per_element_per_buffer_8": us[8] / 8,
            "marginal_us_per_element": (us[8] - us[1]) / 7,
            "dispatches": [s["dispatches"] for s in segs],
            "retraces": [s["retraces"] for s in segs]}
    line = fu_chain_line(8, FU_CHAIN_PARITY, FU_CHAIN_PARITY)
    _, fused = fu_run(line, True)
    _, plain = fu_run(line, False)
    want = torch.arange(FU_CHAIN_PARITY, dtype=torch.float32) + 8
    if len(fused) != FU_CHAIN_PARITY or len(plain) != FU_CHAIN_PARITY:
        fail(f"fusion chain: {len(fused)} / {len(plain)} sink buffers, "
             f"expected {FU_CHAIN_PARITY}")
    got = torch.stack([t.cpu() for t in fused])
    if not torch.equal(got, torch.stack([t.cpu() for t in plain])):
        fail("fusion chain: fused sink bytes differ from fuse=False")
    if not torch.equal(got[:, 0], want):
        fail("fusion chain: sink values are not counter + 8")
    if res["fused"]["dispatches"] != [FU_CHAIN_BUFS] \
            or res["fused"]["retraces"] != [1]:
        fail(f"fusion chain: fused stats {res['fused']}, expected one "
             f"segment, {FU_CHAIN_BUFS} dispatches and one capture")
    res["sink_bytes_equal"] = True
    return res


def fu_mb_run(fuse: bool) -> dict:
    """The MobileNet line: MB_WARM + MB_MEASURED batches. Frames/s at the
    sink: the sink waits for its own batch's CUDA event (recorded as the
    filter pushes the batch) and stamps the time. A device-wide
    synchronize there, as phase 8 does, would also wait for the batches
    queued behind, and a host that runs ahead of the card by a full
    queue would then see later batches arrive done and count them as
    free. Also the host time from the head transform's chain entry to
    the filter's push of the same batch (the launches it issues, fused
    or not), and the outputs."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n = MB_WARM + MB_MEASURED
    pipe = parse_launch(FU_MB_LINE.format(b=MB_BATCH, n=n), fuse=fuse)
    head, tail = pipe.get("t"), pipe.get("f")
    starts, issue, times, outs = [], [], [], []
    chain, push = head._chain_guarded, tail.push

    def timed_chain(pad, buf):
        starts.append(time.perf_counter())
        chain(pad, buf)

    def timed_push(buf, pad=None):
        issue.append(time.perf_counter() - starts[-1])
        done = torch.cuda.Event()
        done.record()
        buf.meta["fu_done"] = done
        push(buf, pad)

    head._chain_guarded, tail.push = timed_chain, timed_push

    def on_data(buf):
        buf.meta["fu_done"].synchronize()
        times.append(time.perf_counter())
        outs.append(buf.tensors[0])

    pipe.get("out").connect(on_data)
    pipe.play()
    try:
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"fusion mobilenet (fuse={fuse}): {msg}")
    if len(outs) != n:
        fail(f"fusion mobilenet (fuse={fuse}): {len(outs)} sink buffers, "
             f"expected {n}")
    stored = []
    while (b := pipe.get("out").pull(timeout=0.1)) is not None:
        stored.append(b.tensors[0])
    fps = MB_MEASURED * MB_BATCH / (times[-1] - times[MB_WARM - 1])
    return {"pipe": pipe, "outs": outs, "stored": stored,
            "frames_per_s": fps,
            "issue_ms_median": 1e3 * statistics.median(issue[MB_WARM:]),
            "batch_ms_median": 1e3 * statistics.median(
                b - a for a, b in zip(times[MB_WARM - 1:], times[MB_WARM:]))}


def fu_p50(fuse: bool) -> dict:
    """Push-to-sink p50 of one (1, 224, 224, 3) uint8 frame through
    FU_P50_LINE (synchronized at the sink), MB_P50_FRAMES frames after
    MB_P50_WARM warm-up ones; fused segments counted."""
    import threading

    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(FU_P50_LINE, fuse=fuse)
    arrived = threading.Event()

    def on_data(buf):
        torch.cuda.synchronize()
        arrived.set()

    pipe.get("out").connect(on_data)
    frames = mb_host_frames(MB_P50_WARM + MB_P50_FRAMES)
    lat = []
    pipe.play()
    try:
        for i in range(len(frames)):
            arrived.clear()
            t0 = time.perf_counter()
            pipe.get("in").push_buffer(frames[i:i + 1])
            if not arrived.wait(timeout=120):
                fail(f"fusion p50 (fuse={fuse}): frame {i} gave nothing")
            lat.append(time.perf_counter() - t0)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"fusion p50 (fuse={fuse}): {msg}")
    steady = lat[MB_P50_WARM:]
    return {"p50_ms": 1e3 * statistics.median(steady),
            "p90_ms": 1e3 * float(np.percentile(steady, 90)),
            "segments": [dict(s.stats) for s in pipe.fused_segments],
            "stager_puts": sum(s._stager.snapshot()["puts"]
                               for s in pipe.fused_segments
                               if s._stager is not None)}


def fu_mobilenet() -> dict:
    n = MB_WARM + MB_MEASURED
    runs = {"fused": fu_mb_run(True), "unfused": fu_mb_run(False)}
    fused, plain = runs["fused"], runs["unfused"]
    (seg,) = fused["pipe"].fused_segments
    if plain["pipe"].fused_segments:
        fail("fusion mobilenet: fuse=False installed a segment")
    if [el.name for el in seg.elements] != ["t", "f"]:
        fail(f"fusion mobilenet: segment {seg.name}, expected t..f")
    if seg.stats["retraces"] != 1 or seg.stats["dispatches"] != n:
        fail(f"fusion mobilenet: {seg.stats['retraces']} captures and "
             f"{seg.stats['dispatches']} dispatches, expected 1 and {n}")
    for t in fused["outs"] + plain["outs"]:
        if not (t.is_cuda and t.device == torch.device("cuda", 0)
                and tuple(t.shape) == (MB_BATCH, 1001)
                and t.dtype is torch.float32):
            fail(f"fusion mobilenet: output {t.dtype} {tuple(t.shape)} on "
                 f"{t.device}")
    unequal = [i for i, (a, b) in enumerate(zip(fused["outs"],
                                                plain["outs"]))
               if not torch.equal(a, b)]
    if unequal:
        worst = max((fused["outs"][i] - plain["outs"][i]).abs().max().item()
                    for i in unequal)
        fail(f"fusion mobilenet: fused logits differ from fuse=False in "
             f"batches {unequal} (max |err| {worst})")
    # the sink's stored buffers, read after the run, are still the logits
    # each batch had: bit-equal to the unfused run's, each in its own
    # storage (no replay rewrote them)
    stored = fused["stored"]
    if len(stored) != n or any(not torch.equal(a, b) for a, b in
                               zip(stored, plain["stored"])):
        fail("fusion mobilenet: a stored sink buffer changed after the run")
    if len({t.data_ptr() for t in stored}) != n:
        fail("fusion mobilenet: stored sink buffers share storage")
    line = FU_MB_LINE.format(b=MB_BATCH, n=n)
    out = {}
    for key, fuse in (("fused", True), ("unfused", False)):
        r = runs[key]
        busy = mb_device_busy(f"fusion {key}", line, per_batch=1, fuse=fuse)
        out[key] = {k: r[k] for k in ("frames_per_s", "issue_ms_median",
                                      "batch_ms_median")}
        out[key]["device"] = busy
        out[key]["p50"] = fu_p50(fuse)
    p50_segs = out["fused"]["p50"]["segments"]
    if len(p50_segs) != 1 or p50_segs[0]["retraces"] != 1:
        fail(f"fusion p50 line: segments {p50_segs}, expected one capture")
    out["segment"] = dict(seg.stats)
    out["logits_bit_equal"] = True
    return out


def fu_placement() -> dict:
    """place="auto" on the host line with a ProfileStore in a temporary
    directory: the calibrating run, a second run that plans from the
    stored artifact, and the sink bytes against place=False."""
    import os
    import tempfile

    from nnstreamer_tpu_torch.obs import profile as obs_profile
    from nnstreamer_tpu_torch.runtime import placement

    b = MB_BATCH
    res = {"device_count": torch.cuda.device_count()}
    with tempfile.TemporaryDirectory() as store:
        saved = os.environ.get(obs_profile.STORE_ENV)
        os.environ[obs_profile.STORE_ENV] = store
        try:
            # the plan each run starts from, read as play() returns (a
            # calibration window opens inside play(); closing it takes
            # CALIBRATION_DISPATCHES batches)
            at_play = []

            def read_plan(p):
                at_play.append(p._placement_state.snapshot())

            line = FU_PLACE_LINE.format(n=FU_PLACE_BATCHES * b, b=b, k=1)
            pipe, _ = fu_run(line, True, place="auto", keep=False,
                             on_play=read_plan)
            if not at_play[0]["calibrating"] or \
                    at_play[0]["source"] != "heuristic":
                fail(f"placement: the first run did not calibrate "
                     f"({at_play[0]['source']})")
            snap = pipe._placement_state.snapshot()
            (seg,) = pipe.fused_segments
            q = pipe.get("q")
            res["calibration"] = {
                "plan": snap, "dispatches": seg.stats["dispatches"],
                "artifacts": sorted(os.listdir(store)),
                "stager": seg._stager.snapshot() if seg._stager else None,
                "queue_capacity": q.stats["capacity"],
                "queue_retuned": q.stats["retuned"]}
            if snap["calibrating"] or snap["source"] != "profile" \
                    or not res["calibration"]["artifacts"]:
                fail(f"placement: the calibration window did not close and "
                     f"persist ({snap['source']}, calibrating="
                     f"{snap['calibrating']}, store {os.listdir(store)})")
            if seg.stats["dispatches"] < placement.CALIBRATION_DISPATCHES:
                fail(f"placement: {seg.stats['dispatches']} dispatches, "
                     "fewer than the calibration window")
            want_dev = [f"cuda:{i}" for i in range(res["device_count"])]
            if snap["devices"] != want_dev or any(
                    st["device"] != 0 for st in snap["stages"]):
                fail(f"placement: plan devices {snap['devices']}, stages "
                     f"{[st['device'] for st in snap['stages']]}")
            if seg.device != torch.device("cuda", 0):
                fail(f"placement: segment pinned to {seg.device}")
            if not res["calibration"]["stager"] or \
                    not res["calibration"]["stager"]["puts"]:
                fail("placement: host frames did not ride the pinned stager")
            depth = snap["queues"].get("q", {}).get("depth")
            if depth is None or not (placement.MIN_QUEUE_DEPTH <= depth
                                     <= placement.MAX_QUEUE_DEPTH):
                fail(f"placement: queue depth {depth}")
            line = FU_PLACE_LINE.format(n=FU_PLACE_CHECK * b, b=b,
                                        k=FU_PLACE_CHECK)
            placed, placed_outs = fu_run(line, True, place="auto",
                                         on_play=read_plan)
            snap2 = at_play[1]
            res["second_run"] = {"source": snap2["source"],
                                 "calibrating": snap2["calibrating"],
                                 "queue_depth": snap2["queues"].get("q"),
                                 "artifacts": sorted(os.listdir(store))}
            if snap2["source"] != "profile" or snap2["calibrating"]:
                fail(f"placement: the second run did not plan from the "
                     f"stored artifact ({snap2['source']}, calibrating="
                     f"{snap2['calibrating']})")
        finally:
            if saved is None:
                os.environ.pop(obs_profile.STORE_ENV, None)
            else:
                os.environ[obs_profile.STORE_ENV] = saved
    _, plain_outs = fu_run(line, True, place=None)
    if len(placed_outs) != FU_PLACE_CHECK or len(plain_outs) != FU_PLACE_CHECK \
            or any(not torch.equal(a, b)
                   for a, b in zip(placed_outs, plain_outs)):
        fail("placement: place=auto sink bytes differ from place=False")
    res["sink_bytes_equal"] = True
    return res


FU_H2D_LINE = (
    "appsrc name=in max-queued=4 caps=other/tensors,format=static,"
    "dimensions=3:224:224:{b},types=uint8 ! tensor_transform "
    f"mode=arithmetic option={FU_NORM} name=t ! tensor_filter "
    f"framework=torch model={FU_MB_MODEL} name=f ! queue ! tensor_sink "
    "name=out max-stored=1")
# distinct host batches the appsrc line cycles through; batches of the
# host line a run
FU_H2D_DISTINCT, FU_H2D_HOST_BATCHES = 4, 12
FU_H2D_ORDER = ("stager", "plain", "plain", "stager")


class fu_h2d_path:
    """Within the block, fused segments on the card take host frames by
    ``path``: "stager" is the port's own (``FusedSegment._inputs``);
    "plain" is patched in: a blocking pageable ``.to(card)`` of each host
    tensor, as an unfused transform makes. Records each dispatch's host
    time (from the head's entry to the return, the push included)."""

    def __init__(self, path: str):
        self.path, self.dispatch_s = path, []

    def __enter__(self):
        from nnstreamer_tpu_torch.core.buffer import as_torch
        from nnstreamer_tpu_torch.runtime.fusion import FusedSegment

        self._saved = FusedSegment._inputs, FusedSegment.dispatch
        inputs, dispatch = self._saved
        times = self.dispatch_s

        def plain(seg, tensors, home):
            if home.type != "cuda":
                return inputs(seg, tensors, home)
            return [t if isinstance(t, torch.Tensor) and t.is_cuda
                    else as_torch(t).to(home) for t in tensors]

        def timed(seg, pad, buf):
            t0 = time.perf_counter()
            try:
                return dispatch(seg, pad, buf)
            finally:
                times.append(time.perf_counter() - t0)

        if self.path == "plain":
            FusedSegment._inputs = plain
        FusedSegment.dispatch = timed
        return self

    def __exit__(self, *exc):
        from nnstreamer_tpu_torch.runtime.fusion import FusedSegment

        FusedSegment._inputs, FusedSegment.dispatch = self._saved
        return False


def fu_sink_clock(pipe, outs: list) -> list:
    """Stamp, at the sink, the time each buffer's own work finished: the
    filter records a CUDA event as it pushes, the sink waits on it (see
    fu_mb_run). Returns the list the stamps go to; ``outs`` gets each
    buffer's first tensor."""
    tail, times = pipe.get("f"), []
    push = tail.push

    def timed_push(buf, pad=None):
        done = torch.cuda.Event()
        done.record()
        buf.meta["fu_done"] = done
        push(buf, pad)

    def on_data(buf):
        buf.meta["fu_done"].synchronize()
        times.append(time.perf_counter())
        outs.append(buf.tensors[0])

    tail.push = timed_push
    pipe.get("out").connect(on_data)
    return times


def fu_h2d_run(path: str, line: str, frames=None) -> dict:
    """One run of ``line`` under ``path`` (fused, default placement):
    frames/s at the sink over the batches after MB_WARM, the median host
    ms of a dispatch, and the logits. ``frames``: host batches an appsrc
    named ``in`` is fed back to back, MB_WARM + MB_MEASURED of them."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    outs = []
    with fu_h2d_path(path) as rec:
        pipe = parse_launch(line)
        times = fu_sink_clock(pipe, outs)
        pipe.play()
        try:
            if frames is not None:
                src = pipe.get("in")
                for i in range(MB_WARM + MB_MEASURED):
                    src.push_buffer(frames[i % len(frames)])
                src.end_of_stream()
            msg = pipe.wait(timeout=600)
        finally:
            pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"fusion h2d ({path}): {line[:50]}... ended with {msg}")
    (seg,) = pipe.fused_segments
    n = len(times)
    return {"frames_per_s": (n - MB_WARM) * MB_BATCH
            / (times[-1] - times[MB_WARM - 1]),
            "dispatch_ms_median": 1e3 * statistics.median(
                rec.dispatch_s[MB_WARM:]),
            "stager_puts": seg._stager.snapshot()["puts"]
            if seg._stager is not None else 0,
            "batches": n, "outs": outs}


def fu_h2d() -> dict:
    """(d): the stager against the plain path, FU_H2D_ORDER, on three
    lines; logits bit-equal across the runs of each line."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (MB_BATCH, 224, 224, 3), dtype=np.uint8)
              for _ in range(FU_H2D_DISTINCT)]
    host = FU_PLACE_LINE.format(n=FU_H2D_HOST_BATCHES * MB_BATCH,
                                b=MB_BATCH, k=1)
    appsrc = FU_H2D_LINE.format(b=MB_BATCH)
    res = {"order": list(FU_H2D_ORDER), "host_line": [],
           "appsrc_line": [], "p50": []}
    ref = {}
    for path in FU_H2D_ORDER:
        for key, line, fr in (("host_line", host, None),
                              ("appsrc_line", appsrc, frames)):
            r = fu_h2d_run(path, line, fr)
            outs = r.pop("outs")
            if path == "stager" and r["stager_puts"] != r["batches"]:
                fail(f"fusion h2d: {key}: {r['stager_puts']} of "
                     f"{r['batches']} batches rode the stager")
            if path == "plain" and r["stager_puts"]:
                fail(f"fusion h2d: {key} rode the stager on the plain path")
            if key not in ref:
                ref[key] = outs
            elif len(outs) != len(ref[key]) or any(
                    not torch.equal(a, b) for a, b in zip(outs, ref[key])):
                fail(f"fusion h2d: {key} logits differ between paths")
            res[key].append(dict(r, path=path))
        with fu_h2d_path(path):
            p = fu_p50(True)
        res["p50"].append({"path": path, "p50_ms": p["p50_ms"],
                           "p90_ms": p["p90_ms"],
                           "stager_puts": p["stager_puts"]})
    res["logits_bit_equal"] = True
    return res


def phase_fusion(report: dict) -> None:
    from nnstreamer_tpu_torch.runtime import placement

    r = report["fusion"] = {}
    chain = r["chain"] = fu_chain_overhead()
    for key in ("fused", "unfused"):
        c = chain[key]
        print(f"fusion 8-element device chain {key}: "
              f"{c['us_per_buffer_8']:.2f} us a buffer "
              f"({c['us_per_element_per_buffer_8']:.2f} us an element), "
              f"1 element {c['us_per_buffer_1']:.2f} us, marginal "
              f"{c['marginal_us_per_element']:.2f} us an element; "
              f"dispatches {c['dispatches']}, captures {c['retraces']}")
    print(f"fusion chain: sink bytes equal fused and unfused over "
          f"{FU_CHAIN_PARITY} buffers")
    mb = r["mobilenet"] = fu_mobilenet()
    for key in ("fused", "unfused"):
        m = mb[key]
        share = m["device"]["busy_share"]
        print(f"fusion mobilenet line {key}: {m['frames_per_s']:.1f} "
              f"frames/s, host {m['issue_ms_median']:.3f} ms to issue a "
              f"batch, median batch {m['batch_ms_median']:.3f} ms, card "
              "busy " + ("not measured" if share is None
                         else f"{100 * share:.1f}%")
              + f"; batch-1 p50 {m['p50']['p50_ms']:.3f} ms")
    print(f"fusion mobilenet: logits bit-equal fused vs unfused, "
          f"{mb['segment']['retraces']} capture, "
          f"{mb['segment']['dispatches']} dispatches, stored sink buffers "
          "intact")
    pl = r["placement"] = fu_placement()
    cal = pl["calibration"]
    print(f"placement: {pl['device_count']} card(s), plan "
          f"{cal['plan']['devices']} -> stages "
          f"{[st['device'] for st in cal['plan']['stages']]}; calibration "
          f"closed (window {placement.CALIBRATION_DISPATCHES}) in a run "
          f"of {cal['dispatches']} dispatches, "
          f"{len(cal['artifacts'])} artifact saved; queue depth "
          f"{cal['plan']['queues'].get('q', {}).get('depth')} (retuned "
          f"{cal['queue_retuned']}); stager puts {cal['stager']['puts']}; "
          f"second run planned from the {pl['second_run']['source']} "
          "without calibrating; sink bytes equal place=False")
    h2d = r["h2d"] = fu_h2d()
    for key in ("host_line", "appsrc_line"):
        print(f"fusion h2d {key}: " + "; ".join(
            f"{x['path']} {x['frames_per_s']:.1f} frames/s, dispatch "
            f"{x['dispatch_ms_median']:.3f} ms, {x['stager_puts']} of "
            f"{x['batches']} staged" for x in h2d[key]))
    print("fusion h2d batch-1 p50: " + "; ".join(
        f"{x['path']} {x['p50_ms']:.3f} ms ({x['stager_puts']} staged)"
        for x in h2d["p50"])
        + "; logits bit-equal on both paths")


# ---------------------------------------------------------------------------
# phase 14: SingleShot, hot swap and suspend, stream structure
# ---------------------------------------------------------------------------

ST_DEV = torch.device("cuda:0")
ST_POSE = "nnstreamer_tpu_torch.models.posenet:filter_model_u8"
ST_ALT = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_seed1"
ST_SWEEP, ST_SWEEP_INVOKES = (64, 128, 256), 8
ST_SLEEPER = "builtin://sleeper?ms=200&factor=2"
ST_TIMEOUT_MS = 50
# tensor_src pattern=random draws uint8 frames in [0, 127) (as
# nnstreamer_tpu's does): a first element below 64 passes about half the
# batches; every batch's mean is about 63, above 60
ST_IF_LT, ST_AVG_GT, ST_AVG_BUFS = 64, 60, 4
ST_BRANCH_BUFS = MB_WARM + MB_MEASURED
ST_MERGE_BUFS = 4
# hot swap: the reload is issued at this batch's boundary on the
# streaming thread, so the batches before it are the old model's
ST_SWAP_AT = 12
ST_SUSPEND_MS, ST_IDLE_S = 200, 0.5
ST_SUSPEND_LINE = (
    "appsrc name=in caps=other/tensors,format=static,"
    "dimensions=3:224:224:{b},types=uint8 ! tensor_transform "
    f"mode=arithmetic option={FU_NORM} name=t ! tensor_filter "
    f"framework=torch model={FU_MB_MODEL} name=f ! queue ! tensor_sink "
    "name=out max-stored=0")


def st_frames(k: int) -> torch.Tensor:
    """Batch ``k`` of ``tensor_src device=true pattern=random
    dimensions=3:224:224:<MB_BATCH> types=uint8``, made again by the
    source's own generator."""
    from nnstreamer_tpu_torch.elements.src import TensorSrc

    src = TensorSrc(device=True, pattern="random", types="uint8",
                    dimensions=f"3:224:224:{MB_BATCH}")
    return src._device_create(k)[0]


def st_event_sink(pipe, pad_owner: str, pads, sinks) -> dict:
    """Per sink, the arrival time of each buffer once the card finished
    it: an event recorded as ``pad_owner`` pushes it from one of
    ``pads`` rides the buffer's meta, and the sink waits for it."""
    el = pipe.get(pad_owner)
    for pad in (p for p in el.src_pads if p.name in pads):
        orig = pad.push

        def push(buf, _orig=orig):
            ev = torch.cuda.Event()
            ev.record()
            buf.meta["st_done"] = ev
            return _orig(buf)
        pad.push = push
    times = {s: [] for s in sinks}
    for s in sinks:
        def on_data(buf, _t=times[s]):
            ev = buf.meta.get("st_done")
            if ev is not None:
                ev.synchronize()
            _t.append(time.perf_counter())
        pipe.get(s).connect(on_data)
    return times


def st_fps(times: list, per_buffer: int, skip: int) -> Optional[float]:
    """Frames/s between the ``skip``-th arrival and the last."""
    if len(times) <= skip + 1:
        return None
    return (len(times) - 1 - skip) * per_buffer / (times[-1] - times[skip])


def st_play(pipe, what: str, on_play=None):
    from nnstreamer_tpu_torch.core import MessageType

    pipe.play()
    try:
        if on_play is not None:
            on_play(pipe)
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"streams {what}: ended with {msg}")


def st_singleshot() -> dict:
    """(a) bench.py:109-160 on the card: SingleShot warms the shared
    backend and sweeps batch sizes with direct invokes, then the host
    line's filter joins it through shared-tensor-filter-key=bench."""
    from nnstreamer_tpu_torch.backends import base as tbase
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.single import SingleShot

    dev = ST_DEV
    opens = [0]
    real_open = TorchBackend.open

    def counting_open(self, props):
        opens[0] += 1
        return real_open(self, props)

    TorchBackend.open = counting_open
    res: dict = {}
    try:
        single = SingleShot("torch", MB_MODEL, share_key="bench")
        try:
            if single.device != dev:
                fail(f"streams singleshot: opened on {single.device}")
            t0 = time.perf_counter()
            warm = single.invoke(np.zeros((MB_BATCH, 224, 224, 3), np.uint8))
            torch.cuda.current_stream(dev).synchronize()
            res["warm_s"] = time.perf_counter() - t0
            if warm[0].device != dev:
                fail(f"streams singleshot: output on {warm[0].device}")
            sweep = {}
            for b in ST_SWEEP:
                xb = np.zeros((b, 224, 224, 3), np.uint8)
                single.invoke(xb)
                torch.cuda.current_stream(dev).synchronize()
                t0 = time.perf_counter()
                outs = [single.invoke(xb) for _ in range(ST_SWEEP_INVOKES)]
                torch.cuda.current_stream(dev).synchronize()
                sweep[b] = ST_SWEEP_INVOKES * b / (time.perf_counter() - t0)
                del outs
            res["sweep_frames_per_s"] = sweep
            res["sweep_winner"] = max(sweep, key=sweep.get)
            # the host line; its filter joins the shared backend
            n = MB_WARM + MB_MEASURED
            line = (MB_HEAD.format(n=n * MB_BATCH, b=MB_BATCH)
                    + f"! tensor_filter framework=torch model={MB_MODEL} "
                    "shared-tensor-filter-key=bench name=f ! queue ! "
                    "tensor_sink name=out max-stored=0")
            pipe = parse_launch(line)
            times = st_event_sink(pipe, "f", ("src",), ("out",))
            shared = {}

            def on_play(p):
                obs_wait(lambda: p.get("f").backend is not None,
                         "the line's filter to open")
                shared["same"] = p.get("f").backend is single.backend
                shared["refcount"] = tbase._shared["bench"].refcount
            st_play(pipe, "singleshot host line", on_play)
            logits = []
            while (b := pipe.get("out").pull(timeout=0.1)) is not None:
                logits.append(b.tensors[0])
            if len(logits) != n:
                fail(f"streams singleshot: {len(logits)} batches at the "
                     f"line's sink, expected {n}")
            res["line_frames_per_s"] = st_fps(times["out"], MB_BATCH,
                                              MB_WARM - 1)
            if not shared.get("same") or shared.get("refcount") != 2 \
                    or opens[0] != 1:
                fail(f"streams singleshot: filter shares the backend "
                     f"{shared}, opens {opens[0]}; expected one instance, "
                     "refcount 2, one open")
            # a batch made again from the seed, through single.invoke
            k = n - 1
            batch = mb_host_frames(n * MB_BATCH)[k * MB_BATCH:(k + 1) * MB_BATCH]
            direct = single.invoke(batch)[0]
            if direct.device != dev or logits[k].device != dev:
                fail("streams singleshot: logits not on cuda:0")
            if not torch.equal(direct, logits[k]):
                fail("streams singleshot: single.invoke's logits differ "
                     f"from the line's for batch {k}")
            # a wrong-shaped / wrong-typed input is refused before dispatch
            calls = [0]
            inner = single.backend.invoke

            def counted(inputs):
                calls[0] += 1
                return inner(inputs)
            single.backend.invoke = counted
            refusals = []
            for bad, err in ((np.zeros((MB_BATCH, 225, 224, 3), np.uint8),
                              ValueError),
                             (np.zeros((MB_BATCH, 224, 224, 3), np.float32),
                              TypeError)):
                try:
                    single.invoke(bad)
                except err as e:
                    refusals.append(str(e))
                else:
                    fail(f"streams singleshot: {bad.shape} {bad.dtype} "
                         "was not refused")
            if calls[0]:
                fail("streams singleshot: a refused input reached the model")
            res["refusals"] = refusals
            # batch-1 p50 of a direct invoke, done on the card
            x1 = batch[:1]
            lat = []
            for i in range(MB_P50_WARM + MB_P50_FRAMES):
                t0 = time.perf_counter()
                single.invoke(x1)
                torch.cuda.current_stream(dev).synchronize()
                if i >= MB_P50_WARM:
                    lat.append(1e3 * (time.perf_counter() - t0))
            res["batch1_p50_ms"] = statistics.median(lat)
        finally:
            single.close()
        if "bench" in tbase._shared:
            fail("streams singleshot: the shared entry outlived both users")
        # a wedged invoke times out; the next call gets its own answer
        with SingleShot("torch", ST_SLEEPER, timeout_ms=ST_TIMEOUT_MS) as s:
            x = torch.ones(4, device=dev)
            s.invoke(x, timeout_ms=0)
            try:
                s.invoke(x)
            except TimeoutError as e:
                res["timeout"] = str(e)
            else:
                fail("streams singleshot: the sleeper did not time out")
            time.sleep(0.3)
            fresh = s.invoke(x * 3, timeout_ms=5000)[0]
            if fresh.device != dev or not torch.equal(
                    fresh, torch.full_like(x, 6.0)):
                fail(f"streams singleshot: after a timeout the next invoke "
                     f"returned {fresh}, not its own result")
    finally:
        TorchBackend.open = real_open
    return res


def st_branch_line(cv: str, opt: str, op: str, val: int, n: int) -> str:
    return (
        f"tensor_src device=true dimensions=3:224:224:{MB_BATCH} "
        f"types=uint8 pattern=random num-buffers={n} name=src ! tensor_if "
        f"name=tif compared-value={cv} compared-value-option={opt} "
        f"operator={op} supplied-value={val} then=passthrough else=skip ! "
        f"tee name=t t. ! queue ! tensor_filter framework=torch "
        f"model={MB_MODEL} name=fm ! mux.sink_0 t. ! queue ! tensor_filter "
        f"framework=torch model={ST_POSE} name=fp ! mux.sink_1 tensor_mux "
        "name=mux ! tensor_demux name=d tensorpick=0,1 d.src_0 ! "
        f"tensor_decoder mode=image_labeling frames-in={MB_BATCH} name=dec "
        "! tensor_sink name=lab max-stored=0 d.src_1 ! tensor_sink name=out "
        "max-stored=0")


def st_branch() -> dict:
    """(b) tensor_if → tee → MobileNet and PoseNet → tensor_mux →
    tensor_demux → labels and pose outputs, at batch 64 on the card."""
    from nnstreamer_tpu_torch.backends.base import (FilterProperties,
                                                    acquire_backend,
                                                    release_backend)
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    dev = ST_DEV
    res: dict = {}
    pipe = parse_launch(st_branch_line("a-value", "0:0", "lt", ST_IF_LT,
                                       ST_BRANCH_BUFS))
    devices, outs = set(), {"d.src_0": [], "d.src_1": []}
    for el in pipe.elements.values():
        if el.name in ("dec", "lab", "out"):
            continue
        for pad in el.src_pads:
            orig = pad.push

            def push(buf, _orig=orig, _name=f"{el.name}.{pad.name}"):
                for t in buf.tensors:
                    devices.add(str(t.device) if isinstance(t, torch.Tensor)
                                else "host")
                if _name in outs:
                    outs[_name].append((buf.offset, buf.tensors[0]))
                return _orig(buf)
            pad.push = push
    times = st_event_sink(pipe, "d", ("src_0", "src_1"), ("lab", "out"))
    labels = []
    pipe.get("lab").connect(lambda b: labels.append(b.meta["label_index"]))
    st_play(pipe, "branch line")
    if devices != {"cuda:0"}:
        fail(f"streams branch: tensors between source and decoder on "
             f"{sorted(devices)}, expected only cuda:0")
    frames = [st_frames(k) for k in range(ST_BRANCH_BUFS)]
    want = [k for k, f in enumerate(frames) if int(f.reshape(-1)[0]) < ST_IF_LT]
    got = [k for k, _ in outs["d.src_1"]]
    if got != want or [k for k, _ in outs["d.src_0"]] != want:
        fail(f"streams branch: batches {got} passed tensor_if, the host "
             f"decision on the regenerated frames is {want}")
    res["passed"] = len(want)
    res["batches"] = ST_BRANCH_BUFS
    for model, key in ((MB_MODEL, "d.src_0"), (ST_POSE, "d.src_1")):
        alone = acquire_backend("torch", FilterProperties(model=model))
        try:
            for k, t in outs[key]:
                if not torch.equal(alone.invoke([frames[k]])[0], t):
                    fail(f"streams branch: {model} output of batch {k} "
                         "differs from the filter run alone")
        finally:
            release_backend(alone)
    argmax = [int(i) for _, t in outs["d.src_0"]
              for i in t.float().argmax(-1).cpu()]
    if labels != argmax:
        fail("streams branch: labels differ from the argmax of the logits")
    res["labels"] = len(labels)
    res["frames_per_s"] = {
        "lab": st_fps(times["lab"], 1, 2 * MB_BATCH - 1),
        "out": st_fps(times["out"], MB_BATCH, 1)}
    del outs, frames
    busy = mb_device_busy("streams branch", st_branch_line(
        "a-value", "0:0", "lt", ST_IF_LT, ST_BRANCH_BUFS), per_batch=1)
    res["device"] = busy
    # every random batch's mean is ~63: all pass; the card's float32
    # reduce against the host's float64 mean of the regenerated frames
    pipe = parse_launch(st_branch_line("tensor-average-value", "0", "gt",
                                       ST_AVG_GT, ST_AVG_BUFS))
    tif = pipe.get("tif")
    seen = []
    orig_cv = tif._compared_value

    def spy(buf):
        v = orig_cv(buf)
        seen.append((buf.offset, v))
        return v
    tif._compared_value = spy
    n_out = []
    pipe.get("out").connect(n_out.append)
    st_play(pipe, "branch average line")
    rel = []
    for k, (v, approx) in seen:
        host = st_frames(k).cpu().numpy().astype(np.float64).mean()
        if not approx:
            fail("streams branch: the average did not reduce on the card")
        rel.append(abs(v - host) / abs(host))
    if len(seen) != ST_AVG_BUFS or len(n_out) != ST_AVG_BUFS \
            or max(rel) > 1e-6:
        fail(f"streams branch average: {len(seen)} decisions, {len(n_out)} "
             f"passed, relative errors {rel}; expected {ST_AVG_BUFS} and "
             "within 1e-6")
    res["average_rel_err_max"] = max(rel)
    return res


def st_merge() -> dict:
    """(c) tee → tensor_merge option=0 → tensor_split tensorseg=64,64 on
    the card."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    dev = ST_DEV
    pipe = parse_launch(
        f"tensor_src device=true dimensions=3:224:224:{MB_BATCH} "
        f"types=uint8 pattern=random num-buffers={ST_MERGE_BUFS} name=src "
        "! tee name=t t. ! queue ! m.sink_0 t. ! queue ! m.sink_1 "
        "tensor_merge name=m mode=linear option=0 ! tensor_split name=s "
        f"axis=0 tensorseg={MB_BATCH},{MB_BATCH} s.src_0 ! tensor_sink "
        "name=a max-stored=0 s.src_1 ! tensor_sink name=b max-stored=0")
    merged = []
    orig = pipe.get("m").srcpad.push

    def push(buf):
        merged.append(buf.tensors[0])
        return orig(buf)
    pipe.get("m").srcpad.push = push
    st_play(pipe, "merge line")
    halves = [[b.tensors[0] for b in iter(
        lambda s=s: pipe.get(s).pull(timeout=0.1), None)] for s in "ab"]
    if len(merged) != ST_MERGE_BUFS or any(len(h) != ST_MERGE_BUFS
                                           for h in halves):
        fail(f"streams merge: {len(merged)} merged, "
             f"{[len(h) for h in halves]} split buffers")
    for k, m in enumerate(merged):
        f = st_frames(k)
        if m.device != dev or tuple(m.shape) != (2 * MB_BATCH, 224, 224, 3) \
                or not torch.equal(m, torch.cat([f, f])):
            fail(f"streams merge: merged batch {k} is not torch.cat of its "
                 "parts on cuda:0")
        for h in halves:
            if h[k].device != dev or not torch.equal(h[k], f):
                fail(f"streams merge: split half of batch {k} differs")
    return {"merged_shape": list(merged[0].shape), "buffers": len(merged)}


def st_swap_outputs(model: str, swap_at: Optional[int] = None) -> dict:
    """Phase 13b's fused device line; with ``swap_at``, ``reload_model``
    to ST_ALT at that batch's boundary on the streaming thread."""
    line = FU_MB_LINE.format(b=MB_BATCH, n=ST_BRANCH_BUFS).replace(
        FU_MB_MODEL, model)
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(line)
    head, f = pipe.get("t"), pipe.get("f")
    times = st_event_sink(pipe, "f", ("src",), ("out",))
    marks = {}
    if swap_at is not None:
        chain = head._chain_guarded

        def chain_with_swap(pad, buf):
            if buf.offset == swap_at:
                marks["reload_t"] = time.perf_counter()
                f.reload_model(ST_ALT)
                marks["reloaded_t"] = time.perf_counter()
            chain(pad, buf)
        head._chain_guarded = chain_with_swap
    st_play(pipe, f"swap line ({model})")
    outs = []
    while (b := pipe.get("out").pull(timeout=0.1)) is not None:
        outs.append(b.tensors[0])
    return {"pipe": pipe, "f": f, "outs": outs, "times": times["out"],
            **marks}


def st_swap() -> dict:
    """(d) hot swap on the fused MobileNet device line, then suspend."""
    from nnstreamer_tpu_torch.obs import memory as obs_memory
    from nnstreamer_tpu_torch.runtime.element import ElementError
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    dev = ST_DEV
    res: dict = {}
    old = st_swap_outputs(FU_MB_MODEL)["outs"]
    new = st_swap_outputs(ST_ALT)["outs"]
    run = st_swap_outputs(FU_MB_MODEL, swap_at=ST_SWAP_AT)
    outs = run["outs"]
    n = ST_BRANCH_BUFS
    if not (len(old) == len(new) == len(outs) == n):
        fail(f"streams swap: {len(outs)} batches out of {n} "
             f"(alone: {len(old)}, {len(new)})")
    which = []
    for k, t in enumerate(outs):
        a, b = torch.equal(t, old[k]), torch.equal(t, new[k])
        if a == b:
            fail(f"streams swap: batch {k} matches "
                 f"{'both models' if a else 'neither model'}")
        which.append("old" if a else "new")
    first_new = which.index("new") if "new" in which else None
    if first_new != ST_SWAP_AT or "old" in which[first_new:]:
        fail(f"streams swap: the models by batch are {which}; expected "
             f"one switch at batch {ST_SWAP_AT}")
    (seg,) = run["pipe"].fused_segments
    log = [step for step, _ in run["f"].swap_log]
    if seg.stats["retraces"] != 2 or seg.stats["dispatches"] != n:
        fail(f"streams swap: segment stats {seg.stats}; expected 2 "
             f"captures and {n} dispatches")
    if log != ["segment fence", "released"]:
        fail(f"streams swap: the filter's swap log is {log}; expected the "
             "segment's fence, then the release")
    if any(t.device != dev for t in outs):
        fail("streams swap: outputs not on cuda:0")
    res["switch_at"] = first_new
    res["captures"] = seg.stats["retraces"]
    res["swap_log"] = log
    res["reload_call_s"] = run["reloaded_t"] - run["reload_t"]
    res["reload_to_first_new_s"] = run["times"][first_new] - run["reload_t"]
    f = run["f"]
    f.set_property("is-updatable", False)
    refused = []
    for call in (lambda: f.reload_model(FU_MB_MODEL),
                 lambda: f.prepare_model(FU_MB_MODEL)):
        try:
            call()
        except ElementError as e:
            refused.append(str(e).split(": ", 1)[-1])
        else:
            fail("streams swap: is-updatable=false did not refuse")
    if refused != ["model reload refused (is-updatable=false)",
                   "model swap refused (is-updatable=false)"]:
        fail(f"streams swap: refusals {refused}")
    res["refusals"] = refused
    del old, new, outs, run
    # suspend on the fused appsrc form of the line
    pipe = parse_launch(ST_SUSPEND_LINE.format(b=MB_BATCH))
    f, src, out = pipe.get("f"), pipe.get("in"), pipe.get("out")
    from nnstreamer_tpu_torch.core import Buffer

    x = st_frames(0)
    pipe.play()
    try:
        src.push_buffer(Buffer([x]))
        before = out.pull(timeout=120)
        if before is None:
            fail("streams suspend: no output before the suspend")
        before = before.tensors[0]
        (seg,) = pipe.fused_segments
        weights = obs_memory.backend_param_nbytes(f.backend)
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        f.set_property("suspend", ST_SUSPEND_MS)
        time.sleep(ST_IDLE_S)
        torch.cuda.synchronize(dev)
        freed = held - torch.cuda.memory_allocated(dev)
        if f.backend is not None or freed < weights:
            fail(f"streams suspend: after {ST_IDLE_S} s idle the backend "
                 f"is {'open' if f.backend is not None else 'closed'} and "
                 f"{freed} bytes were freed (weights {weights})")
        t0 = time.perf_counter()
        src.push_buffer(Buffer([x]))
        after = out.pull(timeout=120)
        if after is None:
            fail("streams suspend: no output after the reopen")
        after = after.tensors[0]
        torch.cuda.current_stream(dev).synchronize()
        res["reopen_s"] = time.perf_counter() - t0
        if not torch.equal(before, after):
            fail("streams suspend: the reopened model's logits differ")
        res["suspend"] = {"weights_bytes": weights, "freed_bytes": freed,
                          "defused": seg.stats["defused"]}
    finally:
        src.end_of_stream()
        pipe.wait(timeout=60)
        pipe.stop()
    return res


def phase_streams(report: dict) -> None:
    smi = report["device"]
    r = report["streams"] = {}
    a = r["singleshot"] = st_singleshot()
    sw = ", ".join(f"{b}: {v:.1f}" for b, v in a["sweep_frames_per_s"].items())
    print(f"streams ({smi}) singleshot: warm {a['warm_s']:.3f} s; sweep "
          f"frames/s {sw}; winner {a['sweep_winner']}; host line "
          f"{a['line_frames_per_s']:.1f} frames/s through the shared "
          f"backend; batch-1 invoke p50 {a['batch1_p50_ms']:.3f} ms; one "
          "backend opened once, logits bit-equal to the line's, wrong "
          "shape and dtype refused before dispatch, timeout raised and the "
          "next invoke got its own result")
    b = r["branch"] = st_branch()
    busy = b["device"]["busy_share"]
    print(f"streams ({smi}) branch: {b['passed']} of {b['batches']} batches "
          f"passed tensor_if (= the host decision); labels "
          f"{b['frames_per_s']['lab']:.1f} frames/s, pose "
          f"{b['frames_per_s']['out']:.1f} frames/s; card busy "
          + ("not measured" if busy is None else f"{100 * busy:.1f}%")
          + f"; outputs bit-equal to each filter alone, every tensor on "
          f"cuda:0, labels = argmax; average reduce within "
          f"{b['average_rel_err_max']:.3g} of the host's")
    c = r["merge"] = st_merge()
    print(f"streams ({smi}) merge: {c['buffers']} merged {c['merged_shape']} "
          "on cuda:0 = torch.cat of the parts; split halves equal the input")
    d = r["swap"] = st_swap()
    print(f"streams ({smi}) swap: switch at batch {d['switch_at']}, "
          f"{d['captures']} captures, log {d['swap_log']}; reload call "
          f"{d['reload_call_s']:.3f} s, reload to first new-model batch "
          f"{d['reload_to_first_new_s']:.3f} s; is-updatable=false refused; "
          f"suspend freed {d['suspend']['freed_bytes']} bytes (weights "
          f"{d['suspend']['weights_bytes']}), reopen "
          f"{d['reopen_s']:.3f} s with bit-equal logits")


# -- phase 15: plugins (ROADMAP A5b) ---------------------------------------

PL_SSD = "nnstreamer_tpu_torch.models.ssd_mobilenet:filter_model_u8"
# 2 warm-up and 8 measured batches of MB_BATCH frames on each line
PL_WARM, PL_MEASURED = 2, 8
# the base branch's queue: collect_sync keeps every pad's frames without
# bound, so the mixer never blocks the base branch while the decoder
# branch works on a batch; two batches of room, nothing is dropped
PL_BASE_QUEUE = 2 * MB_BATCH
# appsrc-fed frames that videomixer and compositor each mix (one batch),
# timed alone: the blend without the decoder's host work beside it
PL_MIX_FRAMES = MB_BATCH
PL_CLASSES = 1001
PL_FRAME_CAPS = ("other/tensors,format=static,dimensions=3:224:224:"
                 f"{MB_BATCH},types=uint8")
PL_BUILD = ROOT / "build" / "plugins"
PL_HEADER = ROOT / "nnstreamer_tpu_torch" / "native" / "csrc"

# a reference-style converter, filter and decoder (nnstreamer_python's
# user APIs): each records what it was handed
PL_CONVERTER = '''
import numpy as np
import nnstreamer_python as nns


class CustomConverter(object):
    seen = []

    def convert(self, input_array):
        a = input_array[0]
        self.seen.append(type(a).__module__ + "." + type(a).__name__)
        shape = nns.TensorShape([3, 224, 224, len(a) // (224 * 224 * 3)],
                                np.uint8)
        return ([shape], [a], 0, 1)
'''
PL_FILTER = '''
import numpy as np


class Filter:
    seen = []

    def invoke(self, inputs):
        x = inputs[0]
        self.seen.append(type(x).__module__ + "." + type(x).__name__)
        z = np.exp(x - x.max(axis=-1, keepdims=True))
        p = z / z.sum(axis=-1, keepdims=True)
        return [p.argmax(axis=-1).astype(np.int32),
                p.max(axis=-1).astype(np.float32)]
'''
PL_DECODER = '''
import numpy as np


class CustomDecoder(object):
    seen = []

    def getOutCaps(self):
        return b"application/octet-stream"

    def decode(self, raw_data, in_info, rate_n, rate_d):
        self.seen.append((type(raw_data[0]).__name__,
                          [np.dtype(s.getType()).name for s in in_info]))
        labels = np.frombuffer(raw_data[0], np.int32)
        return labels.astype("<i4").tobytes()
'''
# a reference-style C++ plugin (nns_custom_filter.hh): a per-row argmax
# of (rows, classes) float32 logits as int32; with custom=max:bf16 also
# each row's maximum as bfloat16 (round to nearest even, as torch)
PL_PLUGIN = r'''
#include <cstring>
#include <string>

#include "nns_custom_filter.hh"

static uint16_t to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

class RowArgmax : public nns::CustomFilter {
 public:
  explicit RowArgmax(const std::string &options)
      : with_max_(options.find("max:bf16") != std::string::npos) {}

  bool set_input(const nns_tensors_spec *in, nns_tensors_spec *out) override {
    if (in->num != 1 || in->spec[0].dtype != NNS_FLOAT32 ||
        in->spec[0].rank != 2)
      return false;
    rows_ = in->spec[0].dims[0];
    cols_ = in->spec[0].dims[1];
    std::memset(out, 0, sizeof(*out));
    out->num = with_max_ ? 2 : 1;
    out->spec[0].dtype = NNS_INT32;
    out->spec[0].rank = 1;
    out->spec[0].dims[0] = rows_;
    if (with_max_) {
      out->spec[1].dtype = NNS_BFLOAT16;
      out->spec[1].rank = 1;
      out->spec[1].dims[0] = rows_;
    }
    return true;
  }

  int invoke(const nns_tensor_view *in, uint32_t n_in, nns_tensor_view *out,
             uint32_t n_out) override {
    if (n_in != 1 || n_out != (with_max_ ? 2u : 1u)) return -2;
    const float *x = static_cast<const float *>(in[0].data);
    int32_t *arg = static_cast<int32_t *>(out[0].data);
    uint16_t *mx = with_max_ ? static_cast<uint16_t *>(out[1].data) : nullptr;
    for (int64_t r = 0; r < rows_; ++r) {
      const float *row = x + r * cols_;
      int64_t best = 0;
      for (int64_t c = 1; c < cols_; ++c)
        if (row[c] > row[best]) best = c;
      arg[r] = static_cast<int32_t>(best);
      if (mx != nullptr) mx[r] = to_bf16(row[best]);
    }
    return 0;
  }

 private:
  bool with_max_;
  int64_t rows_ = 0, cols_ = 0;
};
NNS_REGISTER_CUSTOM_FILTER(RowArgmax)
'''


def pl_rec(t) -> tuple:
    """(dtype, shape, bytes) of a tensor on the host; bfloat16 through its
    bit patterns."""
    from nnstreamer_tpu_torch.core.buffer import bf16_bits

    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bfloat16:
            return ("bfloat16", tuple(t.shape), bf16_bits(t).tobytes())
        t = t.detach().cpu().numpy()
    a = np.ascontiguousarray(t)
    return (a.dtype.name, a.shape, a.tobytes())


def pl_blend(base: np.ndarray, over: np.ndarray) -> np.ndarray:
    """An RGB frame with an RGBA overlay on top, in plain numpy: alpha in
    [0, 1] from the overlay's fourth channel, float32 arithmetic, clipped
    and truncated to uint8."""
    alpha = over[..., 3:4].astype(np.float32) / 255.0
    out = (base.astype(np.float32) * (1.0 - alpha)
           + over[..., :3].astype(np.float32) * alpha)
    return np.clip(out, 0, 255).astype(np.uint8)


def pl_overlay_line(n_batches: int) -> str:
    b = MB_BATCH
    return (f"videotestsrc num-buffers={n_batches * b} pattern=gradient ! "
            "videoconvert ! videoscale ! "
            f"video/x-raw,width={VL_SIZE},height={VL_SIZE},format=RGB ! "
            "tee name=t t. ! queue max-size-buffers=4 ! tensor_converter "
            f"frames-per-tensor={b} ! tensor_filter framework=torch "
            f"model={PL_SSD} name=f ! tensor_decoder "
            f"{ZOO['ssd_mobilenet'][1]} frames-in={b} name=d ! tee name=o "
            "o. ! queue ! mix.sink_1 "
            "o. ! queue ! tensor_sink name=ov max-stored=1 "
            f"t. ! queue max-size-buffers={PL_BASE_QUEUE} ! mix.sink_0 "
            "compositor name=mix ! tensor_sink name=out max-stored=1")


def pl_mixers_agree(bases, overs) -> dict:
    """The same (base, overlay) pairs through ``appsrc ! videomixer`` and
    ``appsrc ! compositor``: both give the same bytes, equal to
    pl_blend's. Returns the frames compared and the compositor's host ms
    a frame for a blend with nothing else running."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    got, blend_s = {}, []
    for mixer in ("videomixer", "compositor"):
        pipe = parse_launch(
            f"{mixer} name=mix ! tensor_sink name=out max-stored=1 "
            f"appsrc name=b caps=video/x-raw,format=RGB,width={VL_SIZE},"
            f"height={VL_SIZE} ! mix.sink_0 "
            f"appsrc name=o caps=video/x-raw,format=RGBA,width={VL_SIZE},"
            f"height={VL_SIZE} ! mix.sink_1")
        out = got[mixer] = []
        pipe.get("out").connect(
            lambda buf, _o=out: _o.append(np.asarray(buf.tensors[0])))
        mix = pipe.get("mix")
        chain, push, pushed = mix.chain, mix.push, [0]

        def counted(buf, _push=push, _n=pushed):
            _n[0] += 1
            return _push(buf)

        def timed(pad, buf, _chain=chain, _n=pushed, _mixer=mixer):
            # the blend runs in the call that completes a pair (and pushes)
            before = _n[0]
            t0 = time.perf_counter()
            _chain(pad, buf)
            if _mixer == "compositor" and _n[0] > before:
                blend_s.append(time.perf_counter() - t0)
        mix.push, mix.chain = counted, timed
        pipe.play()
        try:
            for base, over in zip(bases, overs):
                pipe.get("b").push_buffer(base)
                pipe.get("o").push_buffer(over)
            pipe.get("b").end_of_stream()
            pipe.get("o").end_of_stream()
            msg = pipe.wait(timeout=120)
        finally:
            pipe.stop()
        if msg.type is not MessageType.EOS:
            fail(f"plugins {mixer}: ended with {msg}")
    a, c = got["videomixer"], got["compositor"]
    if len(a) != len(bases) or len(c) != len(bases):
        fail(f"plugins mixers: {len(a)} / {len(c)} frames for {len(bases)}")
    for i, (x, y, base, over) in enumerate(zip(a, c, bases, overs)):
        if not (np.array_equal(x, y) and np.array_equal(x, pl_blend(base, over))):
            fail(f"plugins mixers: frame {i} differs between videomixer, "
                 "compositor and the numpy blend")
    return {"frames": len(bases),
            "alone_host_ms_per_frame_median": 1e3 * statistics.median(blend_s)}


def pl_overlay() -> dict:
    """(a) The SSD overlay line: every mixed frame, one per source frame
    in pts order, equals the numpy blend of the gradient frame rebuilt on
    the host and the decoder's overlay captured after the tee."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n_batches, b = PL_WARM + PL_MEASURED, MB_BATCH
    pipe = parse_launch(pl_overlay_line(n_batches))
    filt, dec, mix = pipe.get("f"), pipe.get("d"), pipe.get("mix")
    devices, filter_s, decoder_s, mixer_s = set(), [], [], []
    transform = filt.transform

    def tapped(buf):
        t0 = time.perf_counter()
        out = transform(buf)
        filter_s.append(time.perf_counter() - t0)
        devices.add((str(filt.backend_device),)
                    + tuple(str(t.device) for t in out.tensors))
        return out
    filt.transform = tapped
    dec_chain, mix_chain = dec.chain, mix.chain

    def timed_dec(pad, buf):
        t0 = time.perf_counter()
        dec_chain(pad, buf)
        decoder_s.append(time.perf_counter() - t0)
    dec.chain = timed_dec
    pushed = [0]
    mix_push = mix.push

    def counted_push(buf):
        pushed[0] += 1
        return mix_push(buf)
    mix.push = counted_push

    def timed_mix(pad, buf):
        # the blend runs in the call that completes a pair (and pushes)
        before = pushed[0]
        t0 = time.perf_counter()
        mix_chain(pad, buf)
        if pushed[0] > before:
            mixer_s.append(time.perf_counter() - t0)
    mix.chain = timed_mix
    mixed, times, overs = [], [], []

    def on_mixed(buf):
        times.append(time.perf_counter())
        mixed.append((buf.pts, np.asarray(buf.tensors[0])))
    pipe.get("out").connect(on_mixed)
    pipe.get("ov").connect(lambda buf: overs.append(np.asarray(buf.tensors[0])))
    pipe.play()
    try:
        msg = pipe.wait(timeout=900)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"plugins overlay line: ended with {msg}")
    n = n_batches * b
    if devices != {("cuda:0", "cuda:0", "cuda:0")}:
        fail(f"plugins overlay: filter (backend, outputs) devices "
             f"{sorted(devices)}, expected cuda:0")
    if len(mixed) != n or len(overs) != n:
        fail(f"plugins overlay: {len(mixed)} mixed frames and {len(overs)} "
             f"overlays for {n} source frames")
    pts = [p for p, _ in mixed]
    if any(p is None for p in pts) or any(y <= x for x, y in zip(pts, pts[1:])):
        fail("plugins overlay: mixed frames not in strictly rising pts order")
    bases = vl_frames(0, n)
    for i, ((_, got), over) in enumerate(zip(mixed, overs)):
        if got.shape != (VL_SIZE, VL_SIZE, 3) or not np.array_equal(
                got, pl_blend(bases[i], over)):
            fail(f"plugins overlay: mixed frame {i} is not the numpy blend "
                 "of its source frame and its overlay")
    covered = [float((o[..., 3] > 0).mean()) for o in overs[::b]]
    steady = slice(PL_WARM, None)
    ends = times[b - 1::b]
    r = {"frames": n, "frames_per_s": PL_MEASURED * b / (
             ends[-1] - ends[PL_WARM - 1]),
         "mixer_host_ms_per_frame_median": 1e3 * statistics.median(
             mixer_s[PL_WARM * b:]),
         "decoder_host_ms_per_batch_median": 1e3 * statistics.median(
             decoder_s[steady]),
         "filter_host_ms_per_batch_median": 1e3 * statistics.median(
             filter_s[steady]),
         "overlay_covered_share_first_frames": covered,
         "mixers": pl_mixers_agree(bases[:PL_MIX_FRAMES],
                                   overs[:PL_MIX_FRAMES])}
    r["device"] = mb_device_busy("plugins overlay", pl_overlay_line(1),
                                 per_batch=b)
    return r


def pl_mnet_easy(dev: torch.device):
    """The served MobileNet-v2 (bf16 on the card) registered as
    custom-easy ``mnet``, with its in/out info (so negotiation runs
    nothing)."""
    from nnstreamer_tpu_torch.backends.custom_easy import register_custom_easy
    from nnstreamer_tpu_torch.core import TensorsInfo
    from nnstreamer_tpu_torch.core.tensors import TensorSpec
    from nnstreamer_tpu_torch.models import mobilenet_v2

    served = mobilenet_v2.filter_model_u8.make(dev)
    register_custom_easy(
        "mnet", lambda ts: [served(ts[0])],
        TensorsInfo.of(TensorSpec((MB_BATCH, 224, 224, 3), "uint8")),
        TensorsInfo.of(TensorSpec((MB_BATCH, PL_CLASSES), "float32")))
    return served


def pl_custom_easy(dev: torch.device) -> dict:
    """(b) ``tensor_src device=true ! tensor_filter framework=custom-easy
    model=mnet ! tensor_decoder mode=image_labeling ! tensor_sink``: the
    logits bit-equal to a direct call on the regenerated frames and on
    cuda:0, the labels their argmax."""
    from nnstreamer_tpu_torch.backends.custom_easy import unregister_custom_easy
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n, b = PL_WARM + PL_MEASURED, MB_BATCH
    served = pl_mnet_easy(dev)
    try:
        pipe = parse_launch(
            f"tensor_src device=true num-buffers={n} dimensions=3:224:224:"
            f"{b} types=uint8 pattern=random ! tensor_filter "
            "framework=custom-easy model=mnet name=f ! tensor_decoder "
            f"mode=image_labeling frames-in={b} name=d ! tensor_sink "
            "name=out max-stored=1")
        filt = pipe.get("f")
        logits = []
        transform = filt.transform

        def tapped(buf):
            out = transform(buf)
            logits.append(out.tensors[0])
            return out
        filt.transform = tapped
        labels, times = [], []

        def on_label(buf):
            times.append(time.perf_counter())
            labels.append(int(buf.meta["label_index"]))
        pipe.get("out").connect(on_label)
        st_play(pipe, "plugins custom-easy line")
        if len(logits) != n or len(labels) != n * b:
            fail(f"plugins custom-easy: {len(logits)} batches, "
                 f"{len(labels)} labels for {n} batches of {b}")
        for k, lg in enumerate(logits):
            if lg.device != dev:
                fail(f"plugins custom-easy: logits of batch {k} on "
                     f"{lg.device}")
            direct = served(st_frames(k))
            if not vl_same_bits(lg, direct):
                fail(f"plugins custom-easy: batch {k}'s logits differ from "
                     "a direct call on the same frames")
        want = torch.cat(logits).argmax(-1).cpu().tolist()
        if labels != want:
            fail("plugins custom-easy: labels are not the argmax of the "
                 "logits")
    finally:
        unregister_custom_easy("mnet")
    return {"frames_per_s": st_fps(times, 1, PL_WARM * b - 1),
            "logits": [lg for lg in logits], "labels": labels}


def pl_frame_bytes(k: int) -> np.ndarray:
    """Batch k of (b)'s frames as one octet buffer."""
    return st_frames(k).cpu().numpy().reshape(-1)


def pl_python(tmp: Path, labels_b: list) -> dict:
    """(c) octet batches → reference-style CustomConverter → MobileNet-v2
    on the card → ``framework=python`` softmax/top-1 → reference-style
    ``mode=python3`` decoder: labels equal (b)'s, every python stage
    handed host arrays, the logits pulled to the host once a batch."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n, b = PL_WARM + PL_MEASURED, MB_BATCH
    conv, filt, dec = tmp / "conv.py", tmp / "top1.py", tmp / "labels.py"
    conv.write_text(PL_CONVERTER)
    filt.write_text(PL_FILTER)
    dec.write_text(PL_DECODER)
    pipe = parse_launch(
        "appsrc name=in caps=application/octet-stream ! tensor_converter "
        f"mode=custom-script:{conv} name=c ! tensor_filter framework=torch "
        f"model={MB_MODEL} name=f ! tensor_filter framework=python "
        f"model={filt} name=py ! tensor_decoder mode=python3 option1={dec} "
        "name=d ! tensor_sink name=out max-stored=1")
    stage_s = {"converter": [], "python_filter": [], "python_decoder": []}

    def timed(el, attr, key):
        fn = getattr(el, attr)

        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            stage_s[key].append(time.perf_counter() - t0)
            return out
        setattr(el, attr, run)
    timed(pipe.get("c"), "transform", "converter")
    timed(pipe.get("py"), "transform", "python_filter")
    timed(pipe.get("d"), "chain", "python_decoder")
    devices = set()
    torch_f = pipe.get("f")
    f_transform = torch_f.transform

    def tapped(buf):
        out = f_transform(buf)
        devices.update(str(t.device) for t in out.tensors)
        return out
    torch_f.transform = tapped
    got = []
    pipe.get("out").connect(
        lambda buf: got.extend(np.frombuffer(
            np.asarray(buf.tensors[0]).tobytes(), "<i4").tolist()))
    pipe.play()
    try:
        for k in range(n):
            pipe.get("in").push_buffer(pl_frame_bytes(k))
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=600)
        py = pipe.get("py").backend
        pulls = py.host_pulls
        seen_f = list(py._obj.seen)
        seen_c = list(pipe.get("c")._ext._inner._inner.seen)
        seen_d = list(pipe.get("d").decoder._inner._inner.seen)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"plugins python line: ended with {msg}")
    if devices != {"cuda:0"}:
        fail(f"plugins python: the torch filter's outputs on {devices}")
    if got != labels_b:
        fail(f"plugins python: {len(got)} labels, "
             f"{sum(x != y for x, y in zip(got, labels_b))} differ from the "
             "custom-easy line's")
    host = {"numpy.ndarray"}
    if set(seen_c) != host or set(seen_f) != host or len(seen_f) != n:
        fail(f"plugins python: the converter got {set(seen_c)}, the filter "
             f"{set(seen_f)} ({len(seen_f)} calls); expected host numpy")
    if {s[0] for s in seen_d} != {"bytes"} or len(seen_d) != n:
        fail(f"plugins python: the decoder got {seen_d[:2]}")
    if pulls != n:
        fail(f"plugins python: the python filter pulled {pulls} card "
             f"tensors for {n} batches, expected one a batch")
    steady = slice(PL_WARM, None)
    return {"labels_equal_custom_easy": True, "logit_pulls": pulls,
            "host_ms_per_batch_median": {
                k: 1e3 * statistics.median(v[steady])
                for k, v in stage_s.items()}}


def pl_build_plugin() -> Path:
    """g++ the inline plugin against the port's header; a failed build
    fails the run."""
    PL_BUILD.mkdir(parents=True, exist_ok=True)
    src, so = PL_BUILD / "row_argmax.cc", PL_BUILD / "librow_argmax.so"
    src.write_text(PL_PLUGIN)
    r = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-I",
         str(PL_HEADER), "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"plugins custom C: g++ failed:\n{r.stderr[-2000:]}")
    return so


def pl_custom_c(labels_b: list) -> dict:
    """(d) ``tensor_src device=true ! MobileNet-v2 ! tensor_filter
    framework=custom`` with the g++-built plugin: its argmax equals
    ``torch.argmax`` of the same logits and (b)'s labels; its bfloat16
    row maximum equals ``max().to(torch.bfloat16)``."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n, b = PL_WARM + PL_MEASURED, MB_BATCH
    so = pl_build_plugin()
    pipe = parse_launch(
        f"tensor_src device=true num-buffers={n} dimensions=3:224:224:{b} "
        f"types=uint8 pattern=random ! tensor_filter framework=torch "
        f"model={MB_MODEL} name=f ! tensor_filter framework=custom "
        f"model={so} custom=max:bf16 name=c ! tensor_sink name=out "
        "max-stored=1")
    logits, outs, c_s = [], [], []
    f = pipe.get("f")
    f_transform, c_transform = f.transform, pipe.get("c").transform

    def tapped(buf):
        out = f_transform(buf)
        logits.append(out.tensors[0])
        return out
    f.transform = tapped

    def timed(buf):
        t0 = time.perf_counter()
        out = c_transform(buf)
        c_s.append(time.perf_counter() - t0)
        return out
    pipe.get("c").transform = timed
    pipe.get("out").connect(lambda buf: outs.append(list(buf.tensors)))
    st_play(pipe, "plugins custom C line")
    if len(outs) != n or len(logits) != n:
        fail(f"plugins custom C: {len(outs)} outputs for {n} batches")
    labels = []
    for k, (lg, (arg, mx)) in enumerate(zip(logits, outs)):
        want = lg.argmax(-1).cpu().numpy().astype(np.int32)
        wmax = lg.max(-1).values.to(torch.bfloat16).cpu()
        if not (isinstance(arg, np.ndarray) and np.array_equal(arg, want)):
            fail(f"plugins custom C: batch {k}'s argmax differs from "
                 "torch.argmax")
        if not (isinstance(mx, torch.Tensor) and mx.dtype is torch.bfloat16
                and pl_rec(mx) == pl_rec(wmax)):
            fail(f"plugins custom C: batch {k}'s bfloat16 maximum differs")
        labels.extend(arg.tolist())
    if labels != labels_b:
        fail("plugins custom C: labels differ from the custom-easy line's")
    return {"host_ms_per_batch_median": 1e3 * statistics.median(
        c_s[PL_WARM:]), "labels_equal_custom_easy": True}


def pl_datarepo(tmp: Path, logits: list, labels_b: list) -> dict:
    """(e) datareposink writes (b)'s logits in bf16 and f32, datareposrc
    reads them back byte-exact; then datareposrc feeds (b)'s frames to
    MobileNet-v2 on the card: labels equal (b)'s, frames/s."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    b = MB_BATCH
    data, meta = tmp / "logits.raw", tmp / "logits.json"
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,num_tensors=2,"
        f"dimensions={PL_CLASSES}:{b}.{PL_CLASSES}:{b},types=bfloat16.float32 "
        f"! datareposink location={data} json={meta}")
    want = []
    pipe.play()
    try:
        for lg in logits[:PL_MEASURED]:
            pair = [lg.to(torch.bfloat16), lg]       # on the card
            want.append(tuple(pl_rec(t) for t in pair))
            pipe.get("in").push_buffer(pair)
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    got = []
    pipe = parse_launch(f"datareposrc location={data} json={meta} ! "
                        "tensor_sink name=out max-stored=1")
    pipe.get("out").connect(
        lambda buf: got.append(tuple(pl_rec(t) for t in buf.tensors)))
    st_play(pipe, "plugins datarepo logits")
    if got != want:
        fail(f"plugins datarepo: {len(got)} samples read back, not "
             "byte-exact to the 8 written")
    frames, fmeta = tmp / "frames.raw", tmp / "frames.json"
    pipe = parse_launch(f"appsrc name=in caps={PL_FRAME_CAPS} ! "
                        f"datareposink location={frames} json={fmeta}")
    pipe.play()
    try:
        for k in range(PL_MEASURED):
            pipe.get("in").push_buffer(st_frames(k).cpu().numpy())
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    epochs = 2
    pipe = parse_launch(
        f"datareposrc location={frames} json={fmeta} epochs={epochs} ! "
        f"queue max-size-buffers=4 ! tensor_filter framework=torch "
        f"model={MB_MODEL} name=f ! tensor_sink name=out max-stored=1")
    times = st_event_sink(pipe, "f", ("src",), ("out",))
    labels = []
    pipe.get("out").connect(
        lambda buf: labels.extend(buf.tensors[0].argmax(-1).tolist()))
    st_play(pipe, "plugins datarepo feed")
    if labels != labels_b[:PL_MEASURED * b] * epochs:
        fail("plugins datarepo: the filter's labels on datareposrc's frames "
             "differ from the custom-easy line's")
    return {"logit_samples_byte_exact": len(got),
            "feed_frames_per_s": st_fps(times["out"], b, PL_WARM - 1),
            "feed_batches": epochs * PL_MEASURED}


def pl_queue_c() -> dict:
    """(f) queue C's crop and sparse lines on bfloat16 card frames
    (``tensor_src device=true``): the sink bytes equal the CPU run's, and
    a random card stream survives the sparse round trip bit for bit."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    src = ("tensor_src device=true {acc}num-buffers={n} dimensions={d} "
           "types=bfloat16 pattern={p}")
    lines = {
        "crop": "tensor_crop name=c ! tensor_sink name=out max-stored=1 "
                + src.format(acc="{acc}", n=2, d="3:8:8:1", p="counter")
                + " ! c.raw tensor_src num-buffers=2 dimensions=4:1 "
                "types=uint32 pattern=ones ! c.info",
        "sparse": src.format(acc="{acc}", n=3, d="4:2", p="counter")
                  + " ! tensor_sparse_enc ! tensor_sparse_dec ! "
                  "tensor_sink name=out max-stored=1",
        "sparse_enc": src.format(acc="{acc}", n=3, d="4:2", p="counter")
                      + " ! tensor_sparse_enc ! tensor_sink name=out "
                      "max-stored=1",
    }
    res = {}
    for name, line in lines.items():
        runs = {}
        for acc in ("", "accelerator=cpu "):
            recs = runs[acc] = []
            pipe = parse_launch(line.format(acc=acc))
            pipe.get("out").connect(
                lambda buf, _r=recs: _r.append(
                    tuple(pl_rec(t) for t in buf.tensors)))
            st_play(pipe, f"plugins queue C {name}")
        if not runs[""] or runs[""] != runs["accelerator=cpu "]:
            fail(f"plugins queue C {name}: the card run's sink bytes differ "
                 "from the CPU run's")
        res[name] = len(runs[""])
    pipe = parse_launch(
        src.format(acc="", n=3, d="64:32", p="random") + " ! tee name=t "
        "t. ! queue ! tensor_sparse_enc ! tensor_sparse_dec ! tensor_sink "
        "name=out max-stored=0 t. ! queue ! tensor_sink name=src "
        "max-stored=0")
    st_play(pipe, "plugins queue C random round trip")
    outs, srcs = [], []
    while (buf := pipe.get("out").pull(timeout=0.1)) is not None:
        outs.append(pl_rec(buf.tensors[0]))
    while (buf := pipe.get("src").pull(timeout=0.1)) is not None:
        srcs.append(pl_rec(buf.tensors[0]))
    if len(outs) != 3 or outs != srcs:
        fail("plugins queue C: a random bfloat16 card stream does not "
             "survive the sparse round trip")
    res["sparse_random_round_trip"] = len(outs)
    return res


def phase_plugins(report: dict) -> None:
    import tempfile

    smi = report["device"]
    r = report["plugins"] = {}
    a = r["overlay"] = pl_overlay()
    busy = a["device"]["busy_share"]
    print(f"plugins ({smi}) overlay: {a['frames']} mixed frames, one per "
          f"source frame in pts order, each the numpy blend; "
          f"{a['frames_per_s']:.1f} frames/s at the mixer's sink; mixer "
          f"{a['mixer_host_ms_per_frame_median']:.3f} ms a frame, decoder "
          f"{a['decoder_host_ms_per_batch_median']:.1f} ms a batch, filter "
          f"{a['filter_host_ms_per_batch_median']:.1f} ms a batch; card busy "
          + ("not measured" if busy is None else f"{100 * busy:.1f}%")
          + f"; videomixer = compositor on {a['mixers']['frames']} frames, "
          f"a blend alone {a['mixers']['alone_host_ms_per_frame_median']:.3f}"
          " ms a frame")
    b = pl_custom_easy(ST_DEV)
    r["custom_easy"] = {"frames_per_s": b["frames_per_s"]}
    print(f"plugins ({smi}) custom-easy: {b['frames_per_s']:.1f} frames/s; "
          "logits bit-equal to direct calls, on cuda:0; labels = argmax")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        c = r["python"] = pl_python(tmp, b["labels"])
        ms = ", ".join(f"{k} {v:.3f}" for k, v in
                       c["host_ms_per_batch_median"].items())
        print(f"plugins ({smi}) python: labels = custom-easy's; host ms a "
              f"batch: {ms}; logits pulled {c['logit_pulls']} times for "
              f"{PL_WARM + PL_MEASURED} batches")
        d = r["custom_c"] = pl_custom_c(b["labels"])
        print(f"plugins ({smi}) custom C: argmax = torch.argmax = "
              f"custom-easy's labels, bf16 max exact; "
              f"{d['host_ms_per_batch_median']:.3f} ms a batch")
        e = r["datarepo"] = pl_datarepo(tmp, b["logits"], b["labels"])
        print(f"plugins ({smi}) datarepo: {e['logit_samples_byte_exact']} "
              f"bf16+f32 logit samples byte-exact; datareposrc feed "
              f"{e['feed_frames_per_s']:.1f} frames/s over "
              f"{e['feed_batches']} batches")
    f = r["queue_c"] = pl_queue_c()
    print(f"plugins ({smi}) queue C on the card: crop {f['crop']}, sparse "
          f"{f['sparse']}, encoder {f['sparse_enc']} buffers equal the CPU "
          f"run; random round trip {f['sparse_random_round_trip']} exact")


# ---------------------------------------------------------------------------
# phase 16: .tflite models on the card (models/tflite_import.py and its
# executors, native/, the tflite and tensorflow backends)

TF_MODEL = ROOT / "tests" / "fixtures" / "mobilenet_v2_1.0_224_int8.tflite"
TF_TINY = ROOT / "tests" / "fixtures" / "tiny_int8_perchannel.tflite"
TF_BATCH = 64
TF_WARM, TF_MEASURED = 2, 8
TF_CPU_FRAMES = 4
TF_LSB = 2                      # fake-quant / float: card vs the CPU run
TF_DEVICE_MODES = ("fake-quant", "float", "int8")
TF_FILTER = ("! tensor_filter framework=torch model={model} "
             "custom=quantized_exec:{mode},batch:{b} name=f ")
TF_TAIL = ("! tee name=t t. ! queue max-size-buffers=4 ! tensor_decoder "
           "mode=image_labeling frames-in={b} ! tensor_sink name=out "
           "max-stored=1 t. ! queue max-size-buffers=4 ! tensor_sink "
           "name=raw max-stored=1")
TF_FUSED_LINE = (
    "tensor_src device=true pattern=random types=uint8 "
    "dimensions=3:224:224:{b} num-buffers={n} ! tensor_transform "
    "mode=arithmetic option=typecast:int16,add:-128,typecast:int8 name=t "
    "! tensor_filter framework=torch model={model} "
    "custom=quantized_exec:int8,batch:{b} name=f ! tensor_sink name=out "
    "max-stored=1")


def tf_lines(mode: str) -> str:
    n = TF_WARM + TF_MEASURED
    filt = TF_FILTER.format(model=TF_MODEL, mode=mode, b=TF_BATCH)
    tail = TF_TAIL.format(b=TF_BATCH)
    if mode == "int8-native":   # the host line
        return (f"tensor_src num-buffers={n * TF_BATCH} dimensions=3:224:224:1 "
                "types=int8 pattern=random ! tensor_aggregator "
                f"frames-out={TF_BATCH} frames-dim=0 concat=true ! queue "
                f"max-size-buffers=4 {filt}{tail}")
    return (f"tensor_src device=true num-buffers={n} "
            f"dimensions=3:224:224:{TF_BATCH} types=int8 pattern=random "
            f"{filt}{tail}")


def tf_device_frames(k: int) -> torch.Tensor:
    """Batch ``k`` of the device line, made again as tensor_src made it
    (seed 0: frame k's generator is seeded with k)."""
    gen = torch.Generator(device=ST_DEV)
    gen.manual_seed(k)
    return torch.randint(0, 127, (TF_BATCH, 224, 224, 3), generator=gen,
                         device=ST_DEV, dtype=torch.int8)


def tf_host_frames(n_batches: int) -> list:
    """The host line's batches, made again as tensor_src made them."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 127, (1, 224, 224, 3)).astype(np.int8)
              for _ in range(n_batches * TF_BATCH)]
    return [np.concatenate(frames[i:i + TF_BATCH])
            for i in range(0, len(frames), TF_BATCH)]


def tf_run(mode: str) -> dict:
    """Drive one mode's line: the filter's raw outputs, the decoder's
    labels, frames/s at the raw sink (each batch stamped once the card
    finished it)."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(tf_lines(mode))
    times = st_event_sink(pipe, "f", ("src",), ("raw",))
    raw, labels = [], []
    pipe.get("raw").connect(lambda b: raw.append(b.tensors[0]))
    pipe.get("out").connect(lambda b: labels.append(b.meta["label_index"]))
    st_play(pipe, f"tflite {mode}")
    n = TF_WARM + TF_MEASURED
    if len(raw) != n or len(labels) != n * TF_BATCH:
        fail(f"tflite {mode}: {len(raw)} output batches and {len(labels)} "
             f"labels, expected {n} and {n * TF_BATCH}")
    want_dev = "cpu" if mode == "int8-native" else str(ST_DEV)
    if any(str(r.device) != want_dev for r in raw):
        fail(f"tflite {mode}: outputs on {sorted({str(r.device) for r in raw})}"
             f", expected {want_dev}")
    am = torch.cat([torch.argmax(r.cpu().to(torch.int32), -1) for r in raw])
    if am.tolist() != labels:
        fail(f"tflite {mode}: a label is not the argmax of its frame's "
             "outputs")
    return {"raw": raw, "labels": labels,
            "frames_per_s": st_fps(times["raw"], TF_BATCH, TF_WARM - 1)}


def tf_fma_convs() -> dict:
    """{(M, K, N, chains, kblock): launches a forward} of the fixture's
    steps that sum in XLA's FMA order at batch TF_BATCH, as GEMMs (M, K) x
    (K, N) in that order: the listed CONV_2Ds and FULLY_CONNECTED, and the
    MEAN of a listed shape (one chain over the window, a column of its
    input's scale)."""
    from collections import Counter

    from nnstreamer_tpu_torch.models.tflite_import import (
        FMA_ORDERS, MEAN_FMA_SHAPES, read_model)

    steps, tensors, *_ = read_model(str(TF_MODEL))
    convs = Counter()
    for code, cfg, ins, outs in steps:
        if code == "CONV_2D":
            oc, kh, kw, ic = tensors[ins[1]].shape
            _, h, w, _ = tensors[ins[0]].shape
            _, oh, ow, _ = tensors[outs[0]].shape
            order = FMA_ORDERS.get((TF_BATCH, h, w, kh, kw,
                                    *cfg["strides"], ic, oc))
            if order:
                convs[(TF_BATCH * oh * ow, kh * kw * ic, oc, *order)] += 1
        elif code == "FULLY_CONNECTED":
            n, k = tensors[ins[1]].shape
            order = FMA_ORDERS.get((TF_BATCH, 1, 1, 1, 1, 1, 1, k, n))
            if order:
                convs[(TF_BATCH, k, n, *order)] += 1
        elif code == "MEAN":
            _, h, w, c = tensors[ins[0]].shape
            if (TF_BATCH, h, w, c) in MEAN_FMA_SHAPES:
                convs[(TF_BATCH * c, h * w, 1, 1, 0)] += 1
    return dict(convs)


def tf_fma_kernel(fake_quant_fn, convs: dict) -> dict:
    """fma_gemm against its plain version, bit for bit, at every shape the
    fake-quant line gives it, on that line's own operands (op 0's im2col,
    the 1x1 convs' and the FC's activations and the MEAN's window of one
    batch-64 forward, caught at the wrapper). Kernel, plain and
    ``torch.matmul`` (TF32 off) times, the bound and the tile the kernel
    picked for each shape, and the times summed over one forward's
    launches."""
    import nnstreamer_tpu_torch.models.tflite_import as ti
    from nnstreamer_tpu_torch.ops.fma_gemm import (fma_gemm, fma_gemm_plain,
                                                   tile_for)

    n0 = fma_gemm.launches
    operands = {}

    def catch(a, b, chains=1, kblock=0):
        # in the layout the forward gives them (op 0's, the MEAN's and the
        # FC's rows lie on a padded pitch)
        key = (a.numel() // a.shape[-1], *b.shape, chains, kblock)
        operands.setdefault(key, []).append(
            (a.reshape(-1, a.shape[-1]), b, chains, kblock))
        return fma_gemm(a, b, chains, kblock)
    ti.fma_gemm = catch
    try:
        fake_quant_fn(tf_device_frames(0))
    finally:
        ti.fma_gemm = fma_gemm
    torch.cuda.synchronize()
    if {k: len(v) for k, v in operands.items()} != convs:
        fail(f"fma_gemm: the fake-quant forward gave it shapes "
             f"{ {k: len(v) for k, v in operands.items()} }, expected {convs}")
    shapes, err = [], 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    side = {"bytes": 0.0, "operations": 0.0}
    for (M, K, N, chains, kblock), args in sorted(operands.items()):
        for a, b, _, _ in args:
            got = fma_gemm(a, b, chains, kblock)
            want = fma_gemm_plain(a, b, chains, kblock)
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"fma_gemm at ({M}, {K}) x ({K}, {N}), {chains} chains, "
                     f"blocks of {kblock}: {int((got != want).sum())} of "
                     f"{got.numel()} values differ from the plain version "
                     "(bit-equal required)")
        # the same rows as a strided view (a channel slice of wider rows)
        # must read as their values
        wide = torch.full((M, K + 8), float("nan"), device=a.device)
        wide[:, 4:4 + K] = a
        if not torch.equal(fma_gemm(wide[:, 4:4 + K], b, chains, kblock), got):
            fail(f"fma_gemm at ({M}, {K}) x ({K}, {N}), {chains} chains, "
                 f"blocks of {kblock}: a strided view of the operand gives "
                 "other values than its contiguous copy")
        by = {"bytes": (M * K + K * N + M * N) * 4 / HBM_BYTES_PER_S * 1e3,
              "operations": 2 * M * N * K / F32_FLOP_PER_S * 1e3}
        one = {"shape_mkn": [M, K, N], "chains": chains, "kblock": kblock,
               "per_forward": len(args),
               "tile": tile_for(M, K, N, chains, kblock),
               "ms": time_ms(fma_gemm, args, reps=5, inner=10),
               "plain_ms": time_ms(fma_gemm_plain, args, reps=3, inner=1),
               "library_ms": time_ms(lambda a, b, *_: torch.matmul(a, b),
                                     args, reps=5, inner=10),
               "bound_ms": max(by.values()),
               "bound_by": max(by, key=by.get)}
        one["ms_over_library"] = one["ms"] / one["library_ms"]
        one["bound_share"] = one["bound_ms"] / one["ms"]
        shapes.append(one)
        for k in total:
            total[k] += len(args) * one[k]
        for k in side:
            side[k] += len(args) * by[k]
    fma_gemm.launches = n0     # comparison launches do not count
    return {"max_abs_err": err, **total, "bound_by": max(side, key=side.get),
            "launches_per_forward": sum(convs.values()), "shapes": shapes}


def tf_dw_shapes() -> dict:
    """{(H, W, C, stride): ops a forward} of the fixture's DEPTHWISE_CONV_2D
    steps that sum in XLA's FMA order at batch TF_BATCH."""
    from collections import Counter

    from nnstreamer_tpu_torch.models.tflite_import import (
        DEPTHWISE_FMA_SHAPES, read_model)

    steps, tensors, *_ = read_model(str(TF_MODEL))
    dws = Counter()
    for code, cfg, ins, outs in steps:
        if code == "DEPTHWISE_CONV_2D":
            _, kh, kw, oc = tensors[ins[1]].shape
            _, h, w, c = tensors[ins[0]].shape
            if (TF_BATCH, h, w, kh, kw, *cfg["strides"], c,
                    oc) in DEPTHWISE_FMA_SHAPES:
                dws[(h, w, c, cfg["strides"][0])] += 1
    return dict(dws)


def tf_dw_kernel(fake_quant_fn, dws: dict) -> dict:
    """depthwise_fma against its plain version, bit for bit, at every shape
    the fake-quant line gives it, on that line's own operands (caught at
    the wrapper during one batch-64 forward). Kernel, plain and grouped
    ``F.conv2d`` (on the pre-padded input) times and the bytes bound for
    each shape, and summed over one forward's launches."""
    import torch.nn.functional as F

    import nnstreamer_tpu_torch.models.tflite_import as ti
    from nnstreamer_tpu_torch.ops.depthwise_fma import (depthwise_fma,
                                                        depthwise_fma_plain)
    from nnstreamer_tpu_torch.ops.depthwise_fma import tile_for as dw_tile_for

    n0 = depthwise_fma.launches
    operands = {}

    def catch(x, w, strides, dilation, pads, out_hw, in_scale=None):
        key = (int(x.shape[1]), int(x.shape[2]), int(x.shape[3]),
               int(strides[0]))
        operands.setdefault(key, []).append(
            (x.contiguous(), w.contiguous(), tuple(strides), tuple(dilation),
             pads, tuple(out_hw), in_scale))
        return depthwise_fma(x, w, strides, dilation, pads, out_hw, in_scale)
    ti.depthwise_fma = catch
    try:
        fake_quant_fn(tf_device_frames(0))
    finally:
        ti.depthwise_fma = depthwise_fma
    torch.cuda.synchronize()
    if {k: len(v) for k, v in operands.items()} != dws:
        fail(f"depthwise_fma: the fake-quant forward gave it shapes "
             f"{ {k: len(v) for k, v in operands.items()} }, expected {dws}")
    shapes, err = [], 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    side = {"bytes": 0.0, "operations": 0.0}
    for (h, w_, c, st), args in sorted(operands.items()):
        for a in args:
            got, want = depthwise_fma(*a), depthwise_fma_plain(*a)
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"depthwise_fma at {h}x{w_}x{c}/{st}: "
                     f"{int((got != want).sum())} of {got.numel()} values "
                     "differ from the plain version (bit-equal required)")
        x, wt, strides, _, ((pt, pb), (pl, pr)), (oh, ow), _ = args[0]
        kh, kw = int(wt.shape[1]), int(wt.shape[2])
        n_out = TF_BATCH * oh * ow * c
        by = {"bytes": (x.numel() + wt.numel() + n_out) * 4
              / HBM_BYTES_PER_S * 1e3,
              "operations": 2 * kh * kw * n_out / F32_FLOP_PER_S * 1e3}
        lib_args = [(F.pad(a[0], (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2),
                     a[1][0].permute(2, 0, 1).unsqueeze(1).contiguous())
                    for a in args]
        one = {"shape_hwc_stride": [h, w_, c, st], "per_forward": len(args),
               "tile": dw_tile_for(TF_BATCH, oh, ow, c, st, torch.cuda
                                   .get_device_properties(x.device)
                                   .multi_processor_count),
               "ms": time_ms(depthwise_fma, args, reps=5, inner=10),
               "plain_ms": time_ms(depthwise_fma_plain, args, reps=3,
                                   inner=1),
               "library_ms": time_ms(
                   lambda xx, ww: F.conv2d(xx, ww, None, strides,
                                           groups=c), lib_args,
                   reps=5, inner=10),
               "bound_ms": max(by.values()), "bound_by": max(by, key=by.get)}
        one["ms_over_library"] = one["ms"] / one["library_ms"]
        one["bound_share"] = one["bound_ms"] / one["ms"]
        shapes.append(one)
        for k in total:
            total[k] += len(args) * one[k]
        for k in side:
            side[k] += len(args) * by[k]
    depthwise_fma.launches = n0     # comparison launches do not count
    return {"max_abs_err": err, **total, "bound_by": max(side, key=side.get),
            "launches_per_forward": sum(dws.values()), "shapes": shapes}


TF_REFERENCE_B64 = (ROOT / "tests" / "fixtures"
                    / "mobilenet_v2_1.0_224_int8_fake_quant_b64.npz")
# fake-quant at batch 64 vs the jitted reference on its fixture's frames:
# the port's CPU run is 0 LSB from it (ROADMAP §C)
TF_REFERENCE_LSB = 0


def tf_reference_b64(fake_quant_fn, frames: np.ndarray) -> dict:
    """The card's fake-quant output on ``frames`` (the host line's first
    batch, which the fixture's seed and bounds make again) against the
    jitted reference's, committed: at most TF_REFERENCE_LSB apart."""
    ref = np.load(TF_REFERENCE_B64)
    if (int(ref["seed"]), int(ref["low"]), int(ref["high"])) != (0, 0, 127) \
            or json.loads(str(ref["options"])) != {
                "quantized_exec": "fake-quant", "batch": str(TF_BATCH)}:
        fail(f"tflite reference: {TF_REFERENCE_B64.name} was made from other "
             "frames or options than the host line's first batch")
    got = fake_quant_fn(torch.from_numpy(frames).to(ST_DEV))[0].cpu().numpy()
    d = np.abs(got.astype(np.int64) - ref["out"].astype(np.int64))
    res = {"max_lsb": int(d.max()), "differ": int((d > 0).sum()),
           "values": int(d.size)}
    if got.shape != ref["out"].shape or res["max_lsb"] > TF_REFERENCE_LSB:
        fail(f"tflite fake-quant: batch-{TF_BATCH} output on the card is "
             f"{res['max_lsb']} LSB from the jitted reference "
             f"({res['differ']} values apart; limit {TF_REFERENCE_LSB})")
    return res


def tf_tiny(native_fn_of) -> dict:
    """All four modes on the tiny per-channel fixture give the port's CPU
    bytes (the three torch modes on the card, int8-native on the host)."""
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    x = torch.from_numpy(np.random.default_rng(3).integers(
        -128, 127, (4, 16, 16, 3)).astype(np.int8))
    res = {}
    for mode in TF_DEVICE_MODES + ("int8-native",):
        opts = {"quantized_exec": mode, "batch": "4"}
        cpu, _, _ = load_tflite(str(TF_TINY), opts, device="cpu")
        want = cpu(x)[0]
        if mode == "int8-native":
            got = torch.from_numpy(native_fn_of(str(TF_TINY))(x)[0])
        else:
            card, _, _ = load_tflite(str(TF_TINY), opts, device=ST_DEV)
            got = card(x.to(ST_DEV))[0]
            if str(got.device) != str(ST_DEV):
                fail(f"tflite tiny {mode}: output on {got.device}")
        want = torch.as_tensor(want)
        if not torch.equal(got.cpu(), want):
            fail(f"tflite tiny {mode}: the card's bytes differ from the CPU "
                 "run's")
        res[mode] = "equal"
    return res


def tf_fused(fuse: bool) -> dict:
    """The uint8 → int8 transform and the int8 filter, fused or not: sink
    outputs, frames/s, and the host ms from the transform's chain entry
    to the filter's push of the same batch (the launches it issues)."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    n = TF_WARM + TF_MEASURED
    pipe = parse_launch(TF_FUSED_LINE.format(b=TF_BATCH, n=n,
                                             model=TF_MODEL), fuse=fuse)
    head, tail = pipe.get("t"), pipe.get("f")
    starts, issue, times, outs = [], [], [], []
    chain, push = head._chain_guarded, tail.push

    def timed_chain(pad, buf):
        starts.append(time.perf_counter())
        chain(pad, buf)

    def timed_push(buf, pad=None):
        issue.append(time.perf_counter() - starts[-1])
        done = torch.cuda.Event()
        done.record()
        buf.meta["tf_done"] = done
        push(buf, pad)

    head._chain_guarded, tail.push = timed_chain, timed_push

    def on_data(buf):
        buf.meta["tf_done"].synchronize()
        times.append(time.perf_counter())
        outs.append(buf.tensors[0])

    pipe.get("out").connect(on_data)
    pipe.play()
    try:
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg.type is not MessageType.EOS:
        fail(f"tflite fused (fuse={fuse}): {msg}")
    if len(outs) != n:
        fail(f"tflite fused (fuse={fuse}): {len(outs)} sink buffers, "
             f"expected {n}")
    segs = pipe.fused_segments
    if fuse and ([[el.name for el in s.elements] for s in segs] != [["t", "f"]]
                 or segs[0].stats["retraces"] != 1):
        fail(f"tflite fused: segments {[dict(s.stats) for s in segs]}, "
             "expected one segment t..f captured once")
    if not fuse and segs:
        fail("tflite fused: fuse=False installed a segment")
    return {"outs": outs,
            "frames_per_s": TF_MEASURED * TF_BATCH / (
                times[-1] - times[TF_WARM - 1]),
            "issue_ms_median": 1e3 * statistics.median(issue[TF_WARM:]),
            "captures": segs[0].stats["retraces"] if segs else 0}


def tf_no_fallback() -> dict:
    """framework=tflite and framework=auto on the fixture: the card's
    machine has no TensorFlow, so each posts a bus ERROR naming it and
    nothing reaches the sink (no quiet switch to the importer)."""
    import importlib.util

    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    if importlib.util.find_spec("tensorflow") is not None:
        fail("tflite no-fallback: tensorflow is installed on this machine")
    res = {}
    for fw in ("tflite", "auto"):
        pipe = parse_launch(
            "tensor_src num-buffers=1 dimensions=3:224:224:1 types=int8 ! "
            f"tensor_filter framework={fw} model={TF_MODEL} ! tensor_sink "
            "name=out")
        got = []
        pipe.get("out").connect(got.append)
        pipe.play()
        try:
            msg = pipe.wait(timeout=120)
        finally:
            pipe.stop()
        text = str(msg)
        if msg.type is not MessageType.ERROR or "tensorflow" not in text \
                or "FrameworkUnavailable" not in text or got:
            fail(f"tflite no-fallback framework={fw}: {text} "
                 f"({len(got)} buffers at the sink)")
        res[fw] = text[:300]
    return res


def tf_datarepo(tmp: Path) -> dict:
    """datareposrc (shuffled, 2 epochs) feeding the int8 filter on the
    card, with use-native=true (the C++ prefetcher) and false (memmap):
    the same samples in the same order, the same outputs; frames/s."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    data, meta = tmp / "frames.raw", tmp / "frames.json"
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions="
        f"3:224:224:{TF_BATCH},types=int8 ! datareposink location={data} "
        f"json={meta}")
    pipe.play()
    try:
        for fr in tf_host_frames(TF_WARM + TF_MEASURED // 2):
            pipe.get("in").push_buffer(fr)
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    res = {}
    for native in (True, False):
        pipe = parse_launch(
            f"datareposrc location={data} json={meta} epochs=2 "
            f"is-shuffle=true seed=3 use-native={str(native).lower()} "
            "name=src ! queue max-size-buffers=4 "
            + TF_FILTER.format(model=TF_MODEL, mode="int8", b=TF_BATCH)
            + "! tensor_sink name=out max-stored=1")
        times = st_event_sink(pipe, "f", ("src",), ("out",))
        order, outs, used = [], [], []
        src = pipe.get("src")

        def on_data(b, _src=src, _order=order, _outs=outs, _used=used):
            _used.append(_src._native_reader is not None)
            _order.append(b.offset)
            _outs.append(b.tensors[0])

        pipe.get("out").connect(on_data)
        st_play(pipe, f"tflite datarepo use-native={native}")
        res[native] = {"order": order, "outs": outs, "native_used": used,
                       "frames_per_s": st_fps(times["out"], TF_BATCH, 1)}
    a, b = res[True], res[False]
    if not a["native_used"] or not all(a["native_used"]) or \
            any(b["native_used"]):
        fail(f"tflite datarepo: native reader used {a['native_used']} / "
             f"{b['native_used']}, expected only with use-native=true")
    if a["order"] != b["order"] or len(a["order"]) != 2 * (
            TF_WARM + TF_MEASURED // 2) or not all(
            torch.equal(x, y) for x, y in zip(a["outs"], b["outs"])):
        fail(f"tflite datarepo: samples {a['order']} (native) vs "
             f"{b['order']} (memmap) or their outputs differ")
    return {"order": a["order"],
            "native_frames_per_s": a["frames_per_s"],
            "memmap_frames_per_s": b["frames_per_s"]}


def phase_tflite(report: dict) -> None:
    import tempfile

    from nnstreamer_tpu_torch import native
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite
    from nnstreamer_tpu_torch.native import _build, q8

    smi = report["device"]
    r = report["tflite"] = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    # (a) the native host runtime and the q8 engine, built by g++ here
    t0 = time.perf_counter()
    if not (native.available() and q8.available()):
        fail(f"tflite build: native {native.available()}, q8 "
             f"{q8.available()}: {_build.build_logs}")
    r["build"] = {"s": time.perf_counter() - t0, "q8_simd": q8.simd_level()}
    print(f"tflite ({smi}) build: native and q8 built by g++ in "
          f"{r['build']['s']:.2f} s; q8 SIMD level {q8.simd_level()} "
          "(1 = AVX512-VNNI, 0 = scalar)")
    natives = {}

    def native_fn_of(path: str, batch: int = 4):
        key = (path, batch)
        if key not in natives:
            natives[key] = load_tflite(path, {
                "quantized_exec": "int8-native", "batch": str(batch)})[0]
        return natives[key]

    # (b) the four modes; fake-quant's listed convs go through fma_gemm,
    # its listed depthwise convs through depthwise_fma
    from nnstreamer_tpu_torch.ops.depthwise_fma import depthwise_fma
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm

    modes = r["modes"] = {}
    runs = {}
    for mode in TF_DEVICE_MODES + ("int8-native",):
        fma_gemm.launches = depthwise_fma.launches = 0
        runs[mode] = run = tf_run(mode)
        modes[mode] = {"frames_per_s": run["frames_per_s"]}
        if mode == "fake-quant":
            r["fma_gemm_launches"] = fma_gemm.launches
            r["depthwise_fma_launches"] = depthwise_fma.launches
        elif depthwise_fma.launches:
            fail(f"tflite {mode}: {depthwise_fma.launches} depthwise_fma "
                 "launches outside fake-quant")
    convs, dws = tf_fma_convs(), tf_dw_shapes()
    want = sum(convs.values()) * (TF_WARM + TF_MEASURED)
    if r["fma_gemm_launches"] != want:
        fail(f"tflite fake-quant: {r['fma_gemm_launches']} fma_gemm launches,"
             f" expected {want} ({sum(convs.values())} listed convs a "
             "forward)")
    want = sum(dws.values()) * (TF_WARM + TF_MEASURED)
    if not dws or r["depthwise_fma_launches"] != want:
        fail(f"tflite fake-quant: {r['depthwise_fma_launches']} depthwise_fma"
             f" launches, expected {want} ({sum(dws.values())} listed "
             "depthwise convs a forward)")
    nat = native_fn_of(str(TF_MODEL), TF_BATCH)
    for k, out in enumerate(runs["int8"]["raw"]):
        want = nat(tf_device_frames(k).cpu())[0]
        if not np.array_equal(out.cpu().numpy(), want):
            fail(f"tflite int8: batch {k} on the card differs from "
                 "int8-native's bytes")
    fns = {m: load_tflite(str(TF_MODEL), {"quantized_exec": m,
                                         "batch": str(TF_BATCH)},
                          device=ST_DEV)[0] for m in TF_DEVICE_MODES}
    r["fma_gemm"] = fq = tf_fma_kernel(fns["fake-quant"], convs)
    print(f"tflite ({smi}) fma_gemm: {r['fma_gemm_launches']} launches in the "
          f"fake-quant line; = its plain version bit for bit at all "
          f"{len(fq['shapes'])} shapes of a batch-{TF_BATCH} forward, on its "
          f"operands; a forward's {fq['launches_per_forward']} launches take "
          f"{fq['ms']:.6f} ms (plain {fq['plain_ms']:.3f}, torch.matmul "
          f"{fq['library_ms']:.6f}, bound {fq['bound_ms']:.6f} ms by "
          f"{fq['bound_by']}; {fq['ms'] / fq['library_ms']:.3f} x matmul, "
          f"{fq['bound_ms'] / fq['ms']:.3f} of the bound); per shape "
          "(M, K, N, chains, kblock) x launches: ms / bound / matmul, ms over "
          "matmul's, bound over ms, tile (BM, BN, TM, TN, split): "
          + "; ".join(f"{(*x['shape_mkn'], x['chains'], x['kblock'])} "
                      f"x{x['per_forward']} {x['ms']:.6f} / "
                      f"{x['bound_ms']:.6f} / {x['library_ms']:.6f}, "
                      f"{x['ms_over_library']:.3f}, {x['bound_share']:.3f}, "
                      f"{tuple(x['tile'][f] for f in ('bm', 'bn', 'tm', 'tn', 'split'))}"
                      for x in fq["shapes"]))
    r["depthwise_fma"] = dq = tf_dw_kernel(fns["fake-quant"], dws)
    print(f"tflite ({smi}) depthwise_fma: {r['depthwise_fma_launches']} "
          f"launches in the fake-quant line; = its plain version bit for bit "
          f"at all {len(dq['shapes'])} shapes of a batch-{TF_BATCH} forward, "
          f"on its operands; a forward's {dq['launches_per_forward']} "
          f"launches take {dq['ms']:.6f} ms (plain {dq['plain_ms']:.3f}, "
          f"grouped conv2d {dq['library_ms']:.6f}, bound "
          f"{dq['bound_ms']:.6f} ms by {dq['bound_by']}; "
          f"{dq['ms'] / dq['library_ms']:.3f} x conv2d, "
          f"{dq['bound_ms'] / dq['ms']:.3f} of the bound); per shape (H, W, "
          "C, stride) x launches: ms / bound / conv2d, ms over conv2d's, "
          "bound over ms, tile (TH, TW, CB, rows): "
          + "; ".join(f"{tuple(x['shape_hwc_stride'])} x{x['per_forward']} "
                      f"{x['ms']:.6f} / {x['bound_ms']:.6f} / "
                      f"{x['library_ms']:.6f}, {x['ms_over_library']:.3f}, "
                      f"{x['bound_share']:.3f}, "
                      f"{tuple(x['tile'][f] for f in ('th', 'tw', 'cb', 'rows'))}"
                      for x in dq["shapes"]))
    host = tf_host_frames(TF_WARM + TF_MEASURED)
    r["reference_b64"] = tf_reference_b64(fns["fake-quant"], host[0])
    print(f"tflite ({smi}) fake-quant at batch {TF_BATCH} on the card = "
          f"the jitted reference's committed output on the host line's "
          f"first batch: {r['reference_b64']['max_lsb']} LSB, "
          f"{r['reference_b64']['differ']} of {r['reference_b64']['values']}"
          " values apart")
    for k, out in enumerate(runs["int8-native"]["raw"]):
        got = fns["int8"](torch.from_numpy(host[k]).to(ST_DEV))[0]
        if not torch.equal(got.cpu(), out):
            fail(f"tflite int8-native: host batch {k} differs from int8 on "
                 "the card")
    x4 = tf_device_frames(0)[:TF_CPU_FRAMES].cpu()
    for mode in ("fake-quant", "float"):
        cpu = load_tflite(str(TF_MODEL), {"quantized_exec": mode,
                                          "batch": str(TF_CPU_FRAMES)},
                          device="cpu")[0]
        d = (cpu(x4)[0].to(torch.int32)
             - runs[mode]["raw"][0][:TF_CPU_FRAMES].cpu().to(torch.int32))
        modes[mode]["max_lsb_vs_cpu"] = int(d.abs().max())
        if modes[mode]["max_lsb_vs_cpu"] > TF_LSB:
            fail(f"tflite {mode}: {modes[mode]['max_lsb_vs_cpu']} LSB from "
                 f"the CPU run on {TF_CPU_FRAMES} frames (limit {TF_LSB})")
    for mode in TF_DEVICE_MODES:
        xs = [(tf_device_frames(k),) for k in range(3)]
        modes[mode]["forward_ms"] = time_ms(fns[mode], xs, reps=5, inner=4)
        busy = mb_device_busy(f"tflite {mode}", tf_lines(mode),
                              per_batch=TF_BATCH)["busy_share"]
        modes[mode]["busy_share"] = busy
    x = host[0]
    nat(x)
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        nat(x)
        samples.append(1e3 * (time.perf_counter() - t0))
    modes["int8-native"]["host_ms_per_batch_median"] = statistics.median(
        samples)
    r["tiny"] = tf_tiny(native_fn_of)
    if (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) != tf32:
        fail("tflite: the TF32 switches changed during the phase")
    for mode, m in modes.items():
        extra = ""
        if "forward_ms" in m:
            busy = m["busy_share"]
            extra = (f"; forward {m['forward_ms']:.3f} ms at batch "
                     f"{TF_BATCH} (CUDA events); card busy "
                     + ("not measured" if busy is None else
                        f"{100 * busy:.1f}%"))
        if "max_lsb_vs_cpu" in m:
            extra += f"; {m['max_lsb_vs_cpu']} LSB from the CPU run"
        if "host_ms_per_batch_median" in m:
            extra += (f"; {m['host_ms_per_batch_median']:.1f} ms a batch on "
                      "the host")
        print(f"tflite ({smi}) {mode}: {m['frames_per_s']:.1f} frames/s"
              + extra)
    print(f"tflite ({smi}) int8 on the card = int8-native bytes on "
          f"{(TF_WARM + TF_MEASURED) * TF_BATCH} frames of each line; labels "
          "= argmax; tiny fixture: all four modes = the CPU run's bytes; TF32 "
          "switches unchanged")
    # (c) fused and not
    fused, plain = tf_fused(True), tf_fused(False)
    if not all(torch.equal(a, b) for a, b in zip(fused["outs"],
                                                  plain["outs"])):
        fail("tflite fused: sink bytes differ between fuse on and off")
    r["fused"] = {k: {kk: v for kk, v in d.items() if kk != "outs"}
                  for k, d in (("on", fused), ("off", plain))}
    print(f"tflite ({smi}) fused int8 line: one capture; sink bytes equal "
          f"fused and not; host ms to issue a batch {fused['issue_ms_median']:.3f}"
          f" fused, {plain['issue_ms_median']:.3f} not; "
          f"{fused['frames_per_s']:.1f} / {plain['frames_per_s']:.1f} frames/s")
    # (d) no hidden fallback
    r["no_fallback"] = tf_no_fallback()
    print(f"tflite ({smi}) framework=tflite and framework=auto: a bus ERROR "
          "naming tensorflow (FrameworkUnavailable), nothing at the sink")
    # (e) datareposrc feeding the card
    with tempfile.TemporaryDirectory() as tmp:
        e = r["datarepo"] = tf_datarepo(Path(tmp))
    print(f"tflite ({smi}) datareposrc: the same {len(e['order'])} samples in "
          f"the same order either way; use-native=true "
          f"{e['native_frames_per_s']:.1f} frames/s, false "
          f"{e['memmap_frames_per_s']:.1f} frames/s")


# ---------------------------------------------------------------------------
# phase 17: transport and query (transport/, query/, elements/{shard,mqtt},
# utils/ntp.py) — the base LM and MobileNet-v2 served to remote clients

QY_LM_MODEL = "nnstreamer_tpu_torch.models.lm_serving:base"
QY_LM_CAPS = f"other/tensors,format=static,dimensions={PROMPT}:8,types=int32"
QY_MB_CAPS = ("other/tensors,format=static,"
              f"dimensions=3:224:224:{MB_BATCH},types=uint8")
QY_LOGIT_CAPS = ("other/tensors,format=static,"
                 f"dimensions=1001:{MB_BATCH},types=bfloat16")
QY_WARM, QY_MEASURED = 2, 8
QY_SHARD_BATCHES = 4
QY_BRIDGE_CLIENTS = 8
QY_CHILD_TIMEOUT = 600.0
QY_WAIT = 120.0
# the server process: plays one launch line, prints its port, serves until
# its stdin closes, then prints its kernel launches and wire counters. It
# imports only the port, and sets the TF32 switches as main() does, so its
# LM forward is the parent's.
QY_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
for name in ("jax", "jaxlib", "nnstreamer_tpu"):
    sys.modules[name] = None
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
from nnstreamer_tpu_torch.ops.flash_attention import flash_attention
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.transport import stats
pipe = parse_launch(sys.argv[2])
pipe.play()
print(json.dumps({"port": pipe.get("ssrc").bound_port}), flush=True)
sys.stdin.readline()
pipe.stop()
torch.cuda.synchronize()
print(json.dumps({"launches": {"decode_attention": decode_attention.launches,
                               "flash_attention": flash_attention.launches},
                  "wire": stats.snapshot()}), flush=True)
'''


def qy_bytes(t) -> tuple:
    """(dtype name, shape, bytes) of a host or card tensor or an array; a
    bfloat16 tensor by its bit patterns."""
    from nnstreamer_tpu_torch.core import DataType

    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        name = DataType.from_any(t.dtype).value
        if t.dtype is torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    a = np.ascontiguousarray(t)
    return DataType.from_any(a.dtype).value, a.shape, a.tobytes()


def qy_server_line(model: str, caps: str, server_id: int = 0,
                   extra: str = "") -> str:
    return (f"tensor_query_serversrc name=ssrc id={server_id} port=0 "
            f"caps={caps} {extra}! tensor_filter framework=torch "
            f"model={model} name=f ! tensor_query_serversink id={server_id}")


class QyChild:
    """One query server line in its own process (``sys.executable``),
    importing only the port; it stops when its stdin closes."""

    def __init__(self, line: str, what: str):
        import subprocess as sp

        self.what = what
        self.proc = sp.Popen([sys.executable, "-c", QY_CHILD, str(ROOT), line],
                             stdin=sp.PIPE, stdout=sp.PIPE, text=True)
        self.port = self._json("port")["port"]

    def _json(self, key: str) -> dict:
        import threading

        got = {}

        def read():
            for line in self.proc.stdout:
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) and key in obj:
                    got["obj"] = obj
                    return
        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(QY_CHILD_TIMEOUT)
        if "obj" not in got:
            self.kill()
            fail(f"query {self.what}: the server process printed no "
                 f"'{key}' line (exit {self.proc.poll()})")
        return got["obj"]

    def stop(self) -> dict:
        self.proc.stdin.close()
        out = self._json("launches")
        try:
            rc = self.proc.wait(timeout=QY_WAIT)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"query {self.what}: the server process did not exit")
        if rc != 0:
            fail(f"query {self.what}: the server process exited {rc}")
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def qy_wait(cond, what: str, timeout: float = QY_WAIT) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            fail(f"query {what}: nothing within {timeout:.0f} s")
        time.sleep(0.001)


def qy_wire_frames(fmt: str = "shm") -> dict:
    """This process's ``nns_wire_frames_total`` of ``fmt``, by direction,
    read through the metrics' own text."""
    from nnstreamer_tpu_torch.obs import metrics, promtext

    text = metrics.render()
    return {d: promtext.sample(text, "nns_wire_frames_total",
                               {"format": fmt, "direction": d}) or 0.0
            for d in ("tx", "rx")}


def qy_lm(report: dict, prompts, want) -> dict:
    """(a) phase 4's requests through a query client to the base LM server
    in its own process."""
    from nnstreamer_tpu_torch.models.lm_serving import base
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    child = QyChild(qy_server_line(QY_LM_MODEL, QY_LM_CAPS), "lm")
    try:
        shm0 = qy_wire_frames()
        pipe = parse_launch(
            f"appsrc name=in caps={QY_LM_CAPS} ! tensor_query_client name=qc "
            f"host=127.0.0.1 port={child.port} timeout={QY_WAIT} "
            f"! tensor_sink name=out max-stored={REQUESTS}")
        outs, t_out = [], []

        def on_data(buf):
            t_out.append(time.perf_counter())
            outs.append(buf)
        pipe.get("out").connect(on_data)
        pipe.play()
        rtt = []
        try:
            for p in prompts:
                n = len(outs)
                t0 = time.perf_counter()
                pipe.get("in").push_buffer(p)
                qy_wait(lambda: len(outs) > n, "lm request", QY_CHILD_TIMEOUT)
                rtt.append(t_out[n] - t0)
            qc = pipe.get("qc").client
            wire = (qc.wire_format, qc.shm_active)
        finally:
            pipe.stop()
        shm1 = qy_wire_frames()
    except BaseException:
        child.kill()
        raise
    served = child.stop()
    if wire != ("binary", True):
        fail(f"query lm: the handshake selected {wire}, not NNSB with shm")
    shm = {d: shm1[d] - shm0[d] for d in shm1}
    if shm != {"tx": REQUESTS, "rx": REQUESTS}:
        fail(f"query lm: shm frames {shm}, expected {REQUESTS} each way")
    for k, (out, w) in enumerate(zip(outs, want)):
        got = np.asarray(out.as_numpy().tensors[0])
        if not np.array_equal(got, w):
            fail(f"query lm: request {k}'s tokens differ from phase 4's")
    check_launches("query lm server", served["launches"], base.cfg.layers)
    d2h = served["wire"]["d2h"]
    want_d2h = {"tensors": REQUESTS,
                "bytes": REQUESTS * 8 * (PROMPT + STEPS) * 4}
    if d2h != want_d2h:
        fail(f"query lm: the server pulled {d2h} from the card, expected "
             f"{want_d2h} (one copy an answer)")
    local = report["slice"]["float32"]["request_s_steady"]
    r = {"rtt_s": rtt, "local_request_s_steady": local,
         "tokens_per_s_steady": (REQUESTS - 1) * 8 * STEPS / sum(rtt[1:]),
         "launches": served["launches"], "wire": wire, "shm_frames": shm,
         "server_d2h": d2h}
    print(f"query ({report['device']}) lm offload: {REQUESTS} x (8, {PROMPT})"
          f" -> (8, {PROMPT + STEPS}) tokens = phase 4's; NNSB with shm; "
          f"server kernel launches {served['launches']}; "
          f"{r['tokens_per_s_steady']:.1f} generated tokens/s (requests "
          f"2-3); round trips {', '.join(f'{x:.3f}' for x in rtt)} s "
          f"(request 1 incl. model build) vs {local:.3f} s a local request")
    return r


def qy_codec_ms(frames: np.ndarray, logits: torch.Tensor) -> dict:
    """Host ms (median of 5) to encode and to decode one batch up (frames)
    and down (bf16 logits on the card) on each plane, and its wire
    bytes."""
    from nnstreamer_tpu_torch import transport
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.core.serialize import pack_tensors, unpack_tensors

    def med(fn, n=5):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    out = {}
    ring = transport.create_ring(slots=2, slot_bytes=transport.slot_bytes_for(
        len(transport.encode_frame_bytes(Buffer([frames])))))
    try:
        for d, payload in (("up", frames), ("down", logits)):
            buf = Buffer([payload])
            blob = pack_tensors(buf)
            frame = bytes(transport.encode_frame_bytes(buf))

            def shm_round():
                desc = ring.write_frame(transport.encode_frame(buf))
                ring.read_frame(*transport.unpack_descriptor(desc)[1:])
            out[d] = {
                "json_encode_ms": med(lambda: pack_tensors(buf)),
                "json_decode_ms": med(lambda: unpack_tensors(blob)),
                "nnsb_encode_ms": med(lambda: transport.encode_frame(buf)),
                "nnsb_decode_ms": med(lambda: transport.decode_frame(frame)),
                "shm_write_read_ms": med(shm_round),
                "json_bytes": len(blob), "nnsb_bytes": len(frame)}
    finally:
        transport.detach_ring(ring)
    return out


def qy_mobilenet_wire(report: dict) -> dict:
    """(b) MobileNet-v2 behind a query server: the same measured batches
    through a ``tensor_query_client`` line over JSON, NNSB and NNSB with
    shm."""
    from nnstreamer_tpu_torch import transport
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.transport import stats as wire_stats

    n = QY_WARM + QY_MEASURED
    frames = mb_host_frames(n * MB_BATCH).reshape(n, MB_BATCH, 224, 224, 3)
    server = parse_launch(qy_server_line(MB_MODEL, QY_MB_CAPS, 3))
    server.play()
    ways = {"json": "wire=json", "nnsb": "shm=false", "nnsb+shm": ""}
    want_wire = {"json": ("json", False), "nnsb": ("binary", False),
                 "nnsb+shm": ("binary", True)}
    plane = {"json": "json", "nnsb": "binary", "nnsb+shm": "shm"}
    r, outs = {}, {}
    try:
        port = server.get("ssrc").bound_port
        for name, props in ways.items():
            before = {f: qy_wire_frames(f) for f in plane.values()}
            oversize0 = wire_stats.snapshot()["shm"].get("fallback_oversize",
                                                         0)
            pipe = parse_launch(
                f"appsrc name=in caps={QY_MB_CAPS} ! tensor_query_client "
                f"name=qc host=127.0.0.1 port={port} timeout={QY_WAIT} "
                f"{props} ! tensor_sink name=out max-stored=1")
            got, t_out = [], []

            def on_data(buf, got=got, t_out=t_out):
                t_out.append(time.perf_counter())
                got.append(buf.tensors[0])
            pipe.get("out").connect(on_data)
            pipe.play()
            rtt = []
            try:
                for k in range(n):
                    t0 = time.perf_counter()
                    if k == QY_WARM:
                        t_start = t0
                    pipe.get("in").push_buffer(frames[k])
                    qy_wait(lambda: len(got) > k, f"mobilenet {name} batch {k}")
                    rtt.append(t_out[k] - t0)
                qc = pipe.get("qc").client
                wire = (qc.wire_format, qc.shm_active)
            finally:
                pipe.stop()
            if wire != want_wire[name]:
                fail(f"query mobilenet {name}: negotiated {wire}")
            # the server shares this process: each frame is counted by its
            # sender (tx) and its receiver (rx), up and down, so every batch
            # adds 2 to each direction of its plane and 0 to the others
            rose = {f: {d: qy_wire_frames(f)[d] - before[f][d]
                        for d in ("tx", "rx")} for f in plane.values()}
            want = {f: {d: 2 * n if f == plane[name] else 0
                        for d in ("tx", "rx")} for f in plane.values()}
            oversize = (wire_stats.snapshot()["shm"].get(
                "fallback_oversize", 0) - oversize0)
            if rose != want or oversize:
                fail(f"query mobilenet {name}: nns_wire_frames_total rose "
                     f"{rose} and {oversize} frames overflowed a slot, "
                     f"expected {want} and 0")
            outs[name] = got
            r[name] = {"frames_per_s": QY_MEASURED * MB_BATCH
                       / (t_out[-1] - t_start),
                       "rtt_p50_ms": 1e3 * statistics.median(rtt[QY_WARM:]),
                       "rtt_ms": [1e3 * x for x in rtt],
                       "wire_frames": rose}
        # the server's own forward on the same frames
        fwd = server.get("f").backend
        own = [fwd.invoke([torch.from_numpy(frames[k]).to(ST_DEV)])[0]
               for k in range(n)]
        torch.cuda.synchronize()
    finally:
        server.stop()
    for name, got in outs.items():
        for k, (g, o) in enumerate(zip(got, own)):
            if qy_bytes(g) != qy_bytes(o):
                fail(f"query mobilenet {name}: batch {k}'s logits differ "
                     "from the server's own bf16 forward")
    labels = [torch.argmax(o.float(), -1).cpu() for o in own]
    r["codec"] = c = qy_codec_ms(frames[0], own[0])
    r["labels"] = torch.cat(labels).tolist()
    desc = len(transport.pack_descriptor(transport.ring_name("s0c0"), 0, 1, 1))
    for name, key in (("json", "json_bytes"), ("nnsb", "nnsb_bytes"),
                      ("nnsb+shm", None)):
        x = r[name]
        x["socket_bytes_per_batch"] = {
            d: (c[d][key] if key else desc) for d in ("up", "down")}
        print(f"query ({report['device']}) mobilenet {name}: "
              f"{x['frames_per_s']:.1f} frames/s, round trip p50 "
              f"{x['rtt_p50_ms']:.2f} ms a batch of {MB_BATCH}; on the "
              f"socket {x['socket_bytes_per_batch']['up']} B up / "
              f"{x['socket_bytes_per_batch']['down']} B down a batch"
              + (f" (frames of {c['up']['nnsb_bytes']} / "
                 f"{c['down']['nnsb_bytes']} B in the rings)"
                 if key is None else ""))
    c = r["codec"]
    print(f"query ({report['device']}) mobilenet codec, host ms a batch "
          f"(up {c['up']['nnsb_bytes']} B / down {c['down']['nnsb_bytes']} B"
          f" NNSB): JSON encode {c['up']['json_encode_ms']:.3f} / "
          f"{c['down']['json_encode_ms']:.3f}, decode "
          f"{c['up']['json_decode_ms']:.3f} / {c['down']['json_decode_ms']:.3f}"
          f"; NNSB encode {c['up']['nnsb_encode_ms']:.3f} / "
          f"{c['down']['nnsb_encode_ms']:.3f}, decode "
          f"{c['up']['nnsb_decode_ms']:.3f} / {c['down']['nnsb_decode_ms']:.3f}"
          f"; shm write+read {c['up']['shm_write_read_ms']:.3f} / "
          f"{c['down']['shm_write_read_ms']:.3f}; logits byte-equal to the "
          "server's own forward on every way")
    return r


def qy_bridge(report: dict) -> dict:
    """(c) attach_scheduler: batch-1 frames from QY_BRIDGE_CLIENTS clients,
    released by a barrier, share scheduler batches."""
    import threading

    from nnstreamer_tpu_torch.core import Buffer, Caps
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mb
    from nnstreamer_tpu_torch.query.client import QueryClient
    from nnstreamer_tpu_torch.query.server import QueryServer
    from nnstreamer_tpu_torch.serving import Scheduler

    n = QY_BRIDGE_CLIENTS
    model = mb.filter_model_u8.make(ST_DEV)
    frames = mb_host_frames(n)
    want = model(torch.from_numpy(frames).to(ST_DEV)).cpu()
    caps = Caps.new("other/tensors")
    server = QueryServer(port=0, caps=caps)
    sched = Scheduler(lambda x: (model(torch.as_tensor(x).to(ST_DEV)),),
                      bucket_sizes=(n,), max_wait_s=1.0, name="qy-bridge")
    server.attach_scheduler(sched)
    results, errors = {}, []
    barrier = threading.Barrier(n, timeout=QY_WAIT)

    def client(i):
        c = QueryClient("127.0.0.1", server.port, timeout=QY_WAIT)
        try:
            c.connect(caps)
            barrier.wait()
            results[i] = c.request(Buffer([frames[i:i + 1]]),
                                   timeout=QY_WAIT)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
        finally:
            c.close()

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * QY_WAIT)
        snap = sched.metrics_snapshot()
    finally:
        sched.close()
        server.stop()
    if errors or len(results) != n:
        fail(f"query bridge: {len(results)} of {n} answers; {errors}")
    for i in range(n):
        if qy_bytes(results[i].tensors[0]) != qy_bytes(want[i:i + 1]):
            fail(f"query bridge: client {i}'s logits differ from row {i} of "
                 f"a batch-{n} forward")
    if not (snap["completed"] == n and snap["batches"] < n):
        fail(f"query bridge: {snap['completed']} completed in "
             f"{snap['batches']} batches (want {n} in fewer than {n})")
    r = {"requests": n, "batches": snap["batches"]}
    print(f"query ({report['device']}) attach_scheduler: {n} clients' "
          f"batch-1 frames in {snap['batches']} scheduler batch(es); logits "
          f"= a batch-{n} forward's rows")
    return r


def qy_labels(pipe_line: str, frames: np.ndarray, what: str) -> list:
    """Push ``frames`` (batches) through a client line ending in an
    image_labeling decoder; the labels in arrival order."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(pipe_line)
    labels = []
    pipe.get("out").connect(lambda b: labels.append(b.meta["label_index"]))
    pipe.play()
    try:
        for f in frames:
            pipe.get("in").push_buffer(f)
        qy_wait(lambda: len(labels) >= len(frames) * MB_BATCH, what)
    finally:
        pipe.stop()
    return labels


def qy_shard(report: dict, want_labels: list) -> dict:
    """(d) tensor_shard across two server processes on the one card, then
    tensor_unshard; order and labels equal the unsharded line's."""
    frames = mb_host_frames(QY_SHARD_BATCHES * MB_BATCH).reshape(
        QY_SHARD_BATCHES, MB_BATCH, 224, 224, 3)
    tail = (f"! tensor_decoder mode=image_labeling frames-in={MB_BATCH} "
            f"! tensor_sink name=out max-stored=1")
    kids = []
    try:
        for _ in range(2):
            kids.append(QyChild(qy_server_line(MB_MODEL, QY_MB_CAPS),
                                "shard worker"))
        p0, p1 = (k.port for k in kids)
        plain = qy_labels(
            f"appsrc name=in caps={QY_MB_CAPS} ! tensor_query_client "
            f"port={p0} timeout={QY_WAIT} {tail}", frames, "unsharded line")
        t0 = time.perf_counter()
        sharded = qy_labels(
            f"appsrc name=in caps={QY_MB_CAPS} ! tensor_shard name=s "
            f"s.src_0 ! queue ! tensor_query_client port={p0} "
            f"timeout={QY_WAIT} ! u.sink_0 s.src_1 ! queue ! "
            f"tensor_query_client port={p1} timeout={QY_WAIT} ! u.sink_1 "
            f"tensor_unshard name=u {tail}", frames, "sharded line")
        wall = time.perf_counter() - t0
    except BaseException:
        for k in kids:
            k.kill()
        raise
    for k in kids:
        k.stop()
    if sharded != plain:
        fail("query shard: the sharded line's labels or order differ from "
             "the unsharded line's")
    # recorded, not gated: the bf16 forward of another process on the
    # card may pick other cuDNN algorithms than the in-process server's
    r = {"batches": QY_SHARD_BATCHES, "frames_per_s_incl_setup":
         QY_SHARD_BATCHES * MB_BATCH / wall,
         "labels_equal_in_process_server":
             plain == want_labels[:len(plain)]}
    print(f"query ({report['device']}) tensor_shard: {QY_SHARD_BATCHES} "
          f"batches across two server processes, unsharded in order; labels"
          f" = the unsharded line's")
    return r


def qy_edge_mqtt_grpc(report: dict, payload: torch.Tensor) -> dict:
    """(e) one bf16 logits batch (on the card) through edgesink → edgesrc,
    a HYBRID query link discovered over the embedded MiniBroker, mqttsink →
    mqttsrc, and tensor_sink_grpc; the bytes arrive unchanged, or grpc's
    typed error where grpc is absent."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.query.mqtt import MiniBroker
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    want = qy_bytes(payload)

    def same(buf) -> bool:
        return qy_bytes(buf.tensors[0]) == want

    r = {}
    # edge
    pub = parse_launch(f"appsrc name=in caps={QY_LOGIT_CAPS} ! edgesink "
                       "name=pub topic=qy port=0 wait-connection=true "
                       "connection-timeout=60")
    pub.play()
    got = []
    try:
        sub = parse_launch(
            f"edgesrc dest-host=127.0.0.1 dest-port={pub.get('pub').bound_port}"
            " topic=qy num-buffers=1 ! tensor_sink name=out")
        sub.get("out").connect(got.append)
        pub.get("in").push_buffer(payload)
        sub.play()
        try:
            qy_wait(lambda: got, "edge")
        finally:
            sub.stop()
    finally:
        pub.stop()
    if not same(got[0]):
        fail("query edge: edgesrc's bytes differ from edgesink's")
    r["edge"] = "bytes equal"
    broker = MiniBroker()
    try:
        # hybrid: the server advertises on the broker, the client discovers
        srv = parse_launch(qy_server_line(
            "builtin://passthrough", QY_LOGIT_CAPS, 8,
            extra=f"connect-type=HYBRID dest-host=127.0.0.1 "
                  f"dest-port={broker.port} topic=qy/h "))
        srv.play()
        got = []
        try:
            cli = parse_launch(
                f"appsrc name=in caps={QY_LOGIT_CAPS} ! tensor_query_client "
                f"connect-type=HYBRID host=127.0.0.1 port={broker.port} "
                f"topic=qy/h timeout={QY_WAIT} ! tensor_sink name=out")
            cli.get("out").connect(got.append)
            cli.play()
            try:
                cli.get("in").push_buffer(payload)
                qy_wait(lambda: got, "hybrid")
            finally:
                cli.stop()
        finally:
            srv.stop()
        if not same(got[0]):
            fail("query hybrid: the answer's bytes differ from the request's")
        r["hybrid"] = "bytes equal"
        # mqtt: QoS 0 pub/sub, so publish until the subscriber has one
        got = []
        sub = parse_launch(f"mqttsrc host=127.0.0.1 port={broker.port} "
                           "sub-topic=qy/m num-buffers=1 timeout=60 "
                           "! tensor_sink name=out")
        sub.get("out").connect(got.append)
        pub = parse_launch(f"appsrc name=in caps={QY_LOGIT_CAPS} ! mqttsink "
                           f"host=127.0.0.1 port={broker.port} "
                           "pub-topic=qy/m broker=external")
        pub.play()
        sub.play()
        try:
            deadline = time.perf_counter() + QY_WAIT
            while not got and time.perf_counter() < deadline:
                pub.get("in").push_buffer(payload)
                time.sleep(0.05)
        finally:
            sub.stop()
            pub.stop()
        if not got or not same(got[0]):
            fail("query mqtt: mqttsrc's bytes differ from mqttsink's")
        r["mqtt"] = "bytes equal"
    finally:
        broker.stop()
    # grpc
    try:
        import grpc  # noqa: F401
        have_grpc = True
    except ImportError:
        have_grpc = False
    if have_grpc:
        got = []
        recv = parse_launch(f"tensor_src_grpc name=g server=true port=0 "
                            f"caps={QY_LOGIT_CAPS} ! tensor_sink name=out")
        recv.get("out").connect(got.append)
        recv.play()
        try:
            qy_wait(lambda: recv.get("g").bound_port != 0, "grpc bind")
            send = parse_launch(f"appsrc name=in caps={QY_LOGIT_CAPS} ! "
                                "tensor_sink_grpc server=false "
                                f"port={recv.get('g').bound_port}")
            send.play()
            send.get("in").push_buffer(payload)
            qy_wait(lambda: got, "grpc")
            send.stop()
        finally:
            recv.stop()
        if not same(got[0]):
            fail("query grpc: tensor_src_grpc's bytes differ")
        r["grpc"] = "bytes equal"
    else:
        send = parse_launch(f"appsrc name=in caps={QY_LOGIT_CAPS} ! "
                            "tensor_sink_grpc server=false port=1")
        send.play()
        msg = send.bus.wait_for((MessageType.ERROR,), timeout=60)
        send.stop()
        if msg is None or "grpc" not in str(msg.data.get("error", "")):
            fail(f"query grpc: without grpc, expected a bus ERROR naming "
                 f"grpc, got {msg}")
        r["grpc"] = "typed error: " + str(msg.data["error"])[:120]
    print(f"query ({report['device']}) edge, hybrid discovery and mqtt: "
          f"one bf16 batch of logits from the card, bytes equal; grpc: "
          f"{r['grpc']}")
    return r


def phase_query(report: dict, prompts, want) -> None:
    """Phase 17: the base LM and MobileNet-v2 served over the query
    transports (module docstring)."""
    r = report["query"] = {}
    r["lm"] = qy_lm(report, prompts, want)
    r["mobilenet"] = qy_mobilenet_wire(report)
    r["bridge"] = qy_bridge(report)
    r["shard"] = qy_shard(report, r["mobilenet"].pop("labels"))
    payload = torch.from_numpy(mb_host_frames(MB_BATCH)).to(ST_DEV)
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mb

    r["edge"] = qy_edge_mqtt_grpc(report, mb.filter_model_u8.make(ST_DEV)(
        payload).to(torch.bfloat16))


def phase_query_alone(report: dict) -> None:
    """--only query: the kernels built, phase 4's requests served locally
    for the reference tokens, then phase 17."""
    phase_build(report)
    prompts, want = phase_slice(report)
    phase_query(report, prompts, want)


# ---------------------------------------------------------------------------
# phase 18: the service plane (service/, obs/fleet.py, analysis/graph_lint)
# — managed services, supervision, swap and canary, process replicas, the
# autoscaler, the fleet view and the admission lint

SV_LM_MODEL = QY_LM_MODEL
SV_MB_V1 = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8"
SV_MB_V2 = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8_seed1"
# properties every device element of a service line gets (none: the card)
SV_DEVICE_PROPS = ""
# the fault passes (a)'s requests and crashes each run's next one
SV_CRASH_AT = REQUESTS
SV_CYCLES = 3
SV_POLICY = {"mode": "always", "backoff_base_s": 0.5, "jitter": 0.1,
             "max_restarts": 5, "window_s": 600.0}
SV_MEM_SLACK = 64 << 20
SV_FRAME_BATCHES = 8          # distinct batches of 64 frames, cycled
SV_SWAP_AT, SV_AFTER_SWAP = 8, 8
SV_CANARY_BATCHES, SV_CANARY_FRACTION, SV_AFTER_PROMOTE = 40, 0.25, 4
SV_POOL_BATCHES, SV_KILL_AT = 20, 8
SV_FPS_BATCHES, SV_FPS_THREADS = 16, 4
SV_BURST = 12
SV_WAIT = 300.0
SV_SERIES = "serving:query"


def sv_wait(cond, what: str, timeout: float = SV_WAIT, poll: float = 0.02):
    deadline = time.perf_counter() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.perf_counter() > deadline:
            fail(f"service {what}: not within {timeout:.0f} s")
        time.sleep(poll)


def sv_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sv_card_bytes(client) -> int:
    """The serve process's allocated card bytes, from its GET /memory (0
    before the process first touched the card: the model loads at the
    first request)."""
    rows = client.memory()["memory"]["devices"]
    row = [r for r in rows if r["device"] == "cuda:0"]
    return int(row[0]["bytes_in_use"]) if row else 0


class SvServe:
    """``python -m nnstreamer_tpu_torch serve cfg.json`` in a process of its
    own; stops on SIGINT."""

    def __init__(self, cfg: dict, tmp: Path):
        import signal  # noqa: F401 - used in stop()
        import threading

        path = tmp / "serve.json"
        path.write_text(json.dumps(cfg))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "nnstreamer_tpu_torch", "serve",
             str(path)], cwd=str(ROOT), stdout=subprocess.PIPE, text=True)
        got = {}

        def read():
            for line in self.proc.stdout:
                if line.startswith("service control endpoint: "):
                    got["url"] = line.split(": ", 1)[1].strip()
                    return
        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(SV_WAIT)
        if "url" not in got:
            self.kill()
            fail(f"service lm: the serve process printed no endpoint (exit "
                 f"{self.proc.poll()})")
        self.endpoint = got["url"]

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.kill()
                fail("service lm: the serve process did not stop on SIGINT")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def sv_lm_request(port: int, prompt: np.ndarray) -> np.ndarray:
    """One LM request through its own query client (a crash may take its
    connection down); raises on a lost answer."""
    from nnstreamer_tpu_torch.core import Buffer, parse_caps_string
    from nnstreamer_tpu_torch.query.client import QueryClient

    c = QueryClient("127.0.0.1", port, timeout=SV_WAIT)
    try:
        c.connect(parse_caps_string(QY_LM_CAPS))
        out = c.request(Buffer([prompt]), timeout=SV_WAIT)
    finally:
        c.close()
    return np.asarray(out.as_numpy().tensors[0])


def sv_managed_lm(report: dict, prompts, want, tmp: Path) -> dict:
    """(a) the base LM as a managed service in a serve process; (b) its
    supervision through tensor_fault crashes."""
    from nnstreamer_tpu_torch.models.lm_serving import base
    from nnstreamer_tpu_torch.obs import promtext
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.service import ControlClient

    port = sv_free_port()
    launch = (f"tensor_query_serversrc name=ssrc id=40 port={port} "
              f"caps={QY_LM_CAPS} ! tensor_fault name=fault "
              f"crash-at-buffer={SV_CRASH_AT} crash-repeat=true ! "
              "tensor_filter framework=torch model=registry://lm name=f "
              f"{SV_DEVICE_PROPS} ! tensor_query_serversink id=40")
    cfg = {"models": {"lm": {"versions": {"base": SV_LM_MODEL},
                             "active": "base"}},
           "services": [{"name": "lm", "launch": launch,
                         "restart": SV_POLICY, "warmup": "none",
                         "autostart": True}]}
    t0 = time.perf_counter()
    serve = SvServe(cfg, tmp)
    r: dict = {}
    try:
        ctl = ControlClient(serve.endpoint, timeout=60.0)
        st = ctl.status("lm")
        if st["state"] != "ready":
            fail(f"service lm: state {st['state']} after autostart, not "
                 "ready")
        r["start_to_ready_s"] = time.perf_counter() - t0
        r["card_bytes_at_ready"] = sv_card_bytes(ctl)
        # (a) phase 4's requests from a client line
        pipe = parse_launch(
            f"appsrc name=in caps={QY_LM_CAPS} ! tensor_query_client "
            f"host=127.0.0.1 port={port} timeout={SV_WAIT} ! tensor_sink "
            f"name=out max-stored={REQUESTS}")
        outs = []
        pipe.get("out").connect(lambda b: outs.append(b))
        pipe.play()
        rtt = []
        try:
            for p in prompts:
                n, t1 = len(outs), time.perf_counter()
                pipe.get("in").push_buffer(p)
                sv_wait(lambda: len(outs) > n, "lm request")
                rtt.append(time.perf_counter() - t1)
        finally:
            pipe.stop()
        for k, (out, w) in enumerate(zip(outs, want)):
            if not np.array_equal(np.asarray(out.as_numpy().tensors[0]), w):
                fail(f"service lm: request {k}'s tokens differ from phase 4's")
        text = ctl.metrics_text()
        launches = {k: int(promtext.sample(text, "nns_kernel_launches_total",
                                           {"kernel": k}) or 0)
                    for k in ("decode_attention", "flash_attention")}
        check_launches("service lm", launches, base.cfg.layers)
        up = promtext.sample(text, "nns_service_up", {"service": "lm"})
        if up != 1.0:
            fail(f"service lm: nns_service_up is {up}, not 1")
        # the card bytes of the served model, idle after its requests
        mem_served = sv_card_bytes(ctl)
        if mem_served <= 0:
            fail("service lm: the serve process holds no card memory after "
                 "serving: the model did not run on the card")
        r.update(launches=launches, rtt_s=rtt, card_bytes_served=mem_served)
        # (b) crash, supervised restart (the pipeline replayed, STARTING),
        # then READY once the next request's answer reaches the sink (the
        # monitor's first-buffer promotion after a restart)
        cycles = []
        gen = ctl.status("lm")["generation"]
        for c in range(SV_CYCLES):
            try:
                sv_lm_request(port, prompts[0])
                fail(f"service lm: cycle {c}'s crash request was answered")
            except Exception:  # noqa: BLE001 - the crash takes it down
                pass

            def replayed():
                s = ctl.status("lm")
                return s if (s["supervisor"]["restarts"] == c + 1
                             and s["generation"] == gen + c + 1) else None
            st = sv_wait(replayed, f"restart {c + 1}", poll=0.005)
            t_replayed = time.time()
            report_ = st["supervisor"]["crash_reports"][-1]
            if "injected crash" not in report_["error"] or \
                    report_["source"] != "fault":
                fail(f"service lm: crash report {report_['error']!r} from "
                     f"{report_['source']!r}")
            mem = sv_card_bytes(ctl)
            for k, p in enumerate(prompts):
                if not np.array_equal(sv_lm_request(port, p), want[k]):
                    fail(f"service lm: after restart {c + 1}, request "
                         f"{k}'s tokens differ from phase 4's")
                if k == 0:  # the health monitor promotes within a poll
                    sv_wait(lambda: ctl.status("lm")["state"] == "ready",
                            f"READY after restart {c + 1}'s first answer",
                            timeout=10.0, poll=0.005)
                    t_ready = time.time()
            cycles.append({"crash_to_replayed_s":
                           t_replayed - report_["time"],
                           "crash_to_ready_s": t_ready - report_["time"],
                           "card_bytes_at_replay": mem,
                           "card_bytes_served": sv_card_bytes(ctl)})
        r["cycles"] = cycles
        drift = cycles[-1]["card_bytes_served"] - mem_served
        r["card_bytes_drift"] = drift
        if abs(drift) > SV_MEM_SLACK:
            fail(f"service lm: card memory of the served model moved "
                 f"{drift} bytes over {SV_CYCLES} crash/restart cycles "
                 f"(limit {SV_MEM_SLACK})")
        floor = SV_POLICY["backoff_base_s"] * (1 - SV_POLICY["jitter"])
        if min(x["crash_to_replayed_s"] for x in cycles) < floor:
            fail("service lm: the pipeline replayed before the policy's "
                 "backoff")
    except BaseException:
        serve.kill()
        raise
    serve.stop()
    if serve.proc.returncode != 0:
        fail(f"service lm: the serve process exited "
             f"{serve.proc.returncode}")
    print(f"service ({report['device']}) managed lm: serve process READY in "
          f"{r['start_to_ready_s']:.3f} s; phase 4's {REQUESTS} requests = "
          f"phase 4's tokens, server launches {r['launches']}, "
          "nns_service_up 1; round trips "
          + ", ".join(f"{x:.3f}" for x in r["rtt_s"]) + " s; "
          f"{SV_CYCLES} tensor_fault crashes: crash to replay "
          + ", ".join(f"{x['crash_to_replayed_s']:.3f}" for x in cycles)
          + " s, to READY (the next answer) "
          + ", ".join(f"{x['crash_to_ready_s']:.3f}" for x in cycles)
          + f" s (backoff {SV_POLICY['backoff_base_s']} s), next requests "
          f"= phase 4's tokens; card bytes of the served model "
          f"{mem_served} -> "
          + " -> ".join(str(x["card_bytes_served"]) for x in cycles)
          + f" ({drift:+d}), at each replay "
          + ", ".join(str(x["card_bytes_at_replay"]) for x in cycles))
    return r


def sv_frames() -> np.ndarray:
    return mb_host_frames(SV_FRAME_BATCHES * MB_BATCH).reshape(
        SV_FRAME_BATCHES, MB_BATCH, 224, 224, 3)


def sv_forwards(frames: np.ndarray) -> dict:
    """{version: [bytes of each distinct batch's logits]} of the slot's two
    versions, run in this process on the card."""
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mb

    out = {}
    for ver, entry in (("1", mb.filter_model_u8), ("2",
                                                   mb.filter_model_u8_seed1)):
        fn = entry.make(ST_DEV)
        with torch.inference_mode():
            out[ver] = [qy_bytes(fn(torch.from_numpy(f).to(ST_DEV)))
                        for f in frames]
        del fn
    torch.cuda.synchronize()
    return out


def sv_settled_bytes() -> int:
    """The card's allocated bytes once the server threads have dropped the
    last answer's tensors: read until two reads 20 ms apart agree."""
    torch.cuda.synchronize(ST_DEV)
    last = torch.cuda.memory_allocated(ST_DEV)
    for _ in range(100):
        time.sleep(0.02)
        now = torch.cuda.memory_allocated(ST_DEV)
        if now == last:
            return now
        last = now
    fail("service mnet: the card's allocated bytes did not settle in 2 s")


def sv_stream(pipe, frames, first: int, n: int, outs: list,
              times: list) -> None:
    """Push batches first..first+n-1 (cycling the distinct frames) one at a
    time, each after the previous answer."""
    for k in range(first, first + n):
        m = len(outs)
        pipe.get("in").push_buffer(frames[k % len(frames)])
        sv_wait(lambda: len(outs) > m, f"mnet batch {k}")
        times.append(time.perf_counter())


def sv_swap_canary(report: dict, frames, fwd: dict) -> dict:
    """(c) swap and canary on MobileNet-v2 behind an in-process query
    server service."""
    import threading

    from nnstreamer_tpu_torch.obs.memory import backend_param_nbytes
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.service import ServiceManager

    mgr = ServiceManager(jitter_seed=0)
    r: dict = {}
    try:
        mgr.models.define("mnet", {"1": SV_MB_V1, "2": SV_MB_V2},
                          active="1")
        svc = mgr.register(
            "mnet", "tensor_query_serversrc name=ssrc id=41 port=0 "
            f"caps={QY_MB_CAPS} ! tensor_transform mode=typecast "
            f"option=uint8 name=t {SV_DEVICE_PROPS} ! tensor_filter "
            f"framework=torch model=registry://mnet name=f {SV_DEVICE_PROPS} "
            "! tensor_query_serversink id=41", warmup="none").start()
        pipe_s = svc.pipeline
        if len(pipe_s.fused_segments) != 1:
            fail(f"service mnet: {len(pipe_s.fused_segments)} fused "
                 "segments, expected the transform and the filter as one")
        seg = pipe_s.fused_segments[0]
        port = pipe_s.get("ssrc").bound_port
        f = pipe_s.get("f")
        client = parse_launch(
            f"appsrc name=in caps={QY_MB_CAPS} ! tensor_query_client "
            f"host=127.0.0.1 port={port} timeout={SV_WAIT} ! tensor_sink "
            "name=out max-stored=1")
        outs, times = [], []
        client.get("out").connect(lambda b: outs.append(b.tensors[0]))
        client.play()
        try:
            # v1's batches; then the swap, in a thread of its own, while the
            # client streams on until it has finished; then SV_AFTER_SWAP
            # batches, which v2 alone answers
            sv_stream(client, frames, 0, SV_SWAP_AT, outs, times)
            swap_t = {}
            warmed, go = threading.Event(), threading.Event()

            def do_swap():
                try:
                    # the swap's warmup runs on this thread: give it its
                    # cuBLAS handle and workspace (kept per thread, not per
                    # model) before the card bytes are read
                    f.backend.invoke([frames[0]])
                    torch.cuda.synchronize(ST_DEV)
                    warmed.set()
                    go.wait(SV_WAIT)
                    swap_t["start"] = time.perf_counter()
                    swap_t["result"] = mgr.models.swap("mnet", "2")
                    swap_t["end"] = time.perf_counter()
                except Exception as e:  # reported by the gate below
                    swap_t["error"] = repr(e)
                    warmed.set()
            th = threading.Thread(target=do_swap, name="sv:swap")
            th.start()
            if not warmed.wait(SV_WAIT) or "error" in swap_t:
                fail(f"service mnet: the swap thread did not warm: {swap_t}")
            mem0 = sv_settled_bytes()
            param_bytes = backend_param_nbytes(f.backend)
            if param_bytes <= 0:
                fail("service mnet: v1's parameter bytes read 0")
            t_go = time.perf_counter()
            go.set()
            deadline = time.perf_counter() + SV_WAIT
            while th.is_alive():
                if time.perf_counter() > deadline:
                    fail(f"service mnet: the swap ran past {SV_WAIT} s")
                sv_stream(client, frames, len(outs), 1, outs, times)
            th.join()
            if "end" not in swap_t or swap_t["result"]["flipped"] != 1:
                fail(f"service mnet: the swap did not finish: {swap_t}")
            n_after = len(outs)
            sv_stream(client, frames, n_after, SV_AFTER_SWAP, outs, times)
            mem1 = sv_settled_bytes()
            vers = []
            for k, out in enumerate(outs):
                b = qy_bytes(out)
                i = k % len(frames)
                v = "1" if b == fwd["1"][i] else \
                    "2" if b == fwd["2"][i] else None
                if v is None:
                    fail(f"service mnet: swap batch {k}'s answer is neither "
                         "v1's nor v2's forward")
                vers.append(v)
            vs = "".join(vers)
            flip = vs.find("2")
            if flip < SV_SWAP_AT or vs != "1" * flip + "2" * (len(vs) - flip):
                fail(f"service mnet: versions across the swap {vs}: v1 "
                     f"before the swap, then v2 alone")
            if flip > n_after:  # the batches after the swap are all v2
                fail(f"service mnet: v1 answered after the flip {vs}")
            log = [kind for kind, _ in list(f.swap_log)[-2:]]
            if log[-1] != "released" or log[0] not in ("segment fence",
                                                       "stream fence"):
                fail(f"service mnet: swap log {list(f.swap_log)}: the old "
                     "weights were not released after a fence")
            # the same architecture: the old weights went as the new came,
            # so the card's bytes are back where they were (a kept v1 would
            # add its param_bytes)
            if abs(mem1 - mem0) >= param_bytes // 2:
                fail(f"service mnet: card bytes {mem0} before the swap, "
                     f"{mem1} after (the model holds {param_bytes}): the "
                     "old weights were not freed")
            # gaps between answers from the go (the warm-up and the byte
            # read before it are no downtime), by the later batch's index
            ts = [t_go] + times[SV_SWAP_AT:]
            window = {SV_SWAP_AT + i: ts[i + 1] - ts[i]
                      for i in range(len(ts) - 1)
                      if ts[i + 1] >= swap_t["start"]
                      and ts[i] <= swap_t["end"]}
            if not window:
                fail("service mnet: no answer came across the swap")
            gaps = [times[k] - times[k - 1] for k in range(1, SV_SWAP_AT)]
            r["swap"] = {
                "versions": vs,
                "batches_during_swap": n_after - SV_SWAP_AT,
                "swap_s": swap_t["end"] - swap_t["start"],
                "longest_gap_across_flip_s": max(window.values()),
                "longest_gap_at_batch": max(window, key=window.get),
                "first_v2_batch": flip,
                "median_gap_before_s": statistics.median(gaps),
                "fence": log[0],
                "param_bytes": param_bytes,
                "card_bytes_before": mem0,
                "card_bytes_delta": mem1 - mem0}
            # the canary: v1 back at 25% while v2 is active
            d0 = seg.stats["dispatches"]
            mgr.models.canary("mnet", "1", SV_CANARY_FRACTION)
            router = f.backend
            n0 = len(outs)
            sv_stream(client, frames, n0, SV_CANARY_BATCHES, outs, times)
            for i in range(SV_CANARY_BATCHES):
                k = n0 + i
                hit = int((i + 1) * SV_CANARY_FRACTION) > \
                    int(i * SV_CANARY_FRACTION)
                v = "1" if hit else "2"
                if qy_bytes(outs[k]) != fwd[v][k % len(frames)]:
                    fail(f"service mnet: canary batch {i} was not answered "
                         f"by v{v}, as the router's rule gives")
            stats = router.routing_stats()
            want_c = sum(int((i + 1) * SV_CANARY_FRACTION)
                         > int(i * SV_CANARY_FRACTION)
                         for i in range(SV_CANARY_BATCHES))
            if (stats["canary_invokes"], stats["primary_invokes"]) != (
                    want_c, SV_CANARY_BATCHES - want_c):
                fail(f"service mnet: router {stats}, expected {want_c} "
                     "canary invokes")
            if seg.stats["defused"] < 1 or seg.stats["dispatches"] != d0:
                fail(f"service mnet: the segment did not defuse for the "
                     f"canary window ({seg.stats})")
            mgr.models.promote_canary("mnet")
            d1 = seg.stats["dispatches"]
            n1 = len(outs)
            sv_stream(client, frames, n1, SV_AFTER_PROMOTE, outs, times)
            if seg.stats["dispatches"] <= d1:
                fail("service mnet: the segment did not re-fuse after "
                     "promote_canary")
            if any(qy_bytes(outs[n1 + i]) != fwd["1"][(n1 + i) % len(frames)]
                   for i in range(SV_AFTER_PROMOTE)):
                fail("service mnet: after promote an answer is not v1's")
            r["canary"] = {**stats, "defused": seg.stats["defused"],
                           "dispatches_after_promote":
                           seg.stats["dispatches"] - d1}
        finally:
            client.stop()
    finally:
        mgr.shutdown()
    s, c = r["swap"], r["canary"]
    print(f"service ({report['device']}) mnet swap: {len(s['versions'])} "
          f"batches of {MB_BATCH} ({s['batches_during_swap']} during the "
          "swap), none failed, each = v1's or v2's forward byte for byte "
          f"({s['versions']}); swap {s['swap_s']:.3f} s, longest gap across "
          f"the flip {1e3 * s['longest_gap_across_flip_s']:.3f} ms (median "
          f"{1e3 * s['median_gap_before_s']:.3f} ms before); old weights "
          f"released after a {s['fence']}, card bytes "
          f"{s['card_bytes_delta']:+d} across the swap (the model holds "
          f"{s['param_bytes']}); canary "
          f"{SV_CANARY_FRACTION} over {SV_CANARY_BATCHES} batches: "
          f"{c['canary_invokes']} / {c['primary_invokes']} as the rule gives, "
          "the segment defused and re-fused after promote")
    return r


def sv_procreplicas(report: dict, frames, fwd: dict) -> dict:
    """(d) the fabric with process replicas on the card, SIGKILL and
    readmit, an autoscaler step, the fleet view."""
    import threading

    from nnstreamer_tpu_torch.obs.fleet import FleetView
    from nnstreamer_tpu_torch.obs.profile import QuantileDigest
    from nnstreamer_tpu_torch.service import (Autoscaler, AutoscalerConfig,
                                              ProcReplicaSet)

    r: dict = {}
    ps = ProcReplicaSet(
        "mnet-procs",
        f"tensor_filter framework=torch model={SV_MB_V1} {SV_DEVICE_PROPS}",
        QY_MB_CAPS, replicas=2, quarantine_base_s=0.2, health_poll_s=0.05,
        spawn_timeout_s=SV_WAIT)
    scaler = None
    try:
        t0 = time.perf_counter()
        ps.start()
        r["start_2_s"] = time.perf_counter() - t0
        with ps._lock:
            infos = [ps._slots[rid].proc.info for rid in ps._order]
        if any(i.get("devices") != ["cuda:0"] for i in infos):
            fail(f"service procs: replicas report devices "
                 f"{[i.get('devices') for i in infos]}, not cuda:0")

        def check(k, out):
            if qy_bytes(out.tensors[0]) != fwd["1"][k % len(frames)]:
                fail(f"service procs: batch {k}'s answer differs from the "
                     "in-process forward")
        rtt, kill = [], {}

        def readmit(rid):
            dead = sv_wait(ps.reap_dead, "reap", poll=0.005)
            kill["reaped"] = time.perf_counter()
            if dead != [rid] or not ps.respawn(rid):
                kill["error"] = f"reaped {dead}, respawn of {rid} failed"
                return
            sv_wait(lambda: ps.pool.snapshot()["readmissions"] >= 1,
                    "readmit", poll=0.005)
            kill["readmitted"] = time.perf_counter()
        th = None
        for k in range(SV_POOL_BATCHES):
            if k == SV_KILL_AT:
                kill["rid"] = ps.kill_replica(0)
                kill["t"] = time.perf_counter()
                th = threading.Thread(target=readmit, args=(kill["rid"],),
                                      name="sv:readmit")
                th.start()
            t1 = time.perf_counter()
            out = ps.request([frames[k % len(frames)]], key=f"b{k}",
                             timeout=SV_WAIT)
            rtt.append(time.perf_counter() - t1)
            check(k, out)
        th.join(SV_WAIT)
        if "error" in kill or "readmitted" not in kill:
            fail(f"service procs: {kill}")
        snap = ps.pool.snapshot()
        if snap["evictions"] < 1 or snap["request_errors"]:
            fail(f"service procs: pool {snap}")
        r["kill"] = {"replica": kill["rid"],
                     "kill_to_reap_s": kill["reaped"] - kill["t"],
                     "kill_to_readmit_s": kill["readmitted"] - kill["t"],
                     "retries": snap["retries"]}
        r["rtt_p50_ms"] = 1e3 * statistics.median(rtt)

        def fps(n_threads: int) -> float:
            errs = []

            def worker(j):
                for k in range(j, SV_FPS_BATCHES, n_threads):
                    try:
                        check(k, ps.request([frames[k % len(frames)]],
                                            key=f"f{k}", timeout=SV_WAIT))
                    except Exception as e:  # noqa: BLE001 - reported below
                        errs.append(e)
            ts = [threading.Thread(target=worker, args=(j,),
                                   name=f"sv:fps{j}")
                  for j in range(n_threads)]
            t1 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join(SV_WAIT)
            if errs:
                fail(f"service procs: {len(errs)} failed requests: {errs[0]}")
            return SV_FPS_BATCHES * MB_BATCH / (time.perf_counter() - t1)
        r["frames_per_s_2"] = fps(SV_FPS_THREADS)
        # the fleet view: merged request count = the replicas' own
        fv = FleetView("mnet-fleet", source=ps)
        fv.tick()
        merged = fv.request_total(SV_SERIES)
        own = 0
        for rid, ep in ps.control_endpoints().items():
            from nnstreamer_tpu_torch.service import ControlClient

            raw = ControlClient(ep).profile(raw=True)["raw"]
            own += QuantileDigest.from_dict(
                raw["requests"][SV_SERIES]["total"]).count
        if merged is None or merged.count != own or own < SV_POOL_BATCHES:
            fail(f"service procs: fleet-merged {SV_SERIES} count "
                 f"{None if merged is None else merged.count}, replicas' "
                 f"own {own}")
        r["fleet_requests"] = own
        # an autoscaler step: a burst scales out, idle scales back in
        cfg = AutoscalerConfig(
            min_replicas=2, max_replicas=3, latency_slo_s=1e-4,
            short_window_s=2.0, long_window_s=4.0, min_samples=8,
            scale_out_cooldown_s=0.1, scale_in_cooldown_s=0.1,
            memory_max_fraction=0.95, tick_s=3600.0)
        scaler = Autoscaler(ps, cfg, name="mnet-procs").start()
        for k in range(SV_BURST):
            check(k, ps.request([frames[k % len(frames)]], key=f"u{k}",
                                timeout=SV_WAIT))
        t1 = time.perf_counter()
        d_out = scaler.tick()
        r["scale_out_s"] = time.perf_counter() - t1
        n_out = ps.replica_count()
        time.sleep(cfg.long_window_s + 0.5)
        d_in = scaler.tick()
        n_in = ps.replica_count()
        if (d_out["action"], n_out, d_in["action"], n_in) != (
                "scale_out", 3, "scale_in", 2):
            fail(f"service procs: autoscaler {d_out['action']} -> {n_out}, "
                 f"then {d_in['action']} -> {n_in}; expected scale_out -> 3 "
                 "and scale_in -> 2")
        r["autoscale"] = {"out": {k: d_out[k] for k in (
            "burn_short", "samples_short", "replicas")},
            "in": {k: d_in[k] for k in ("burn_short", "burn_long")}}
        ps.scale_in()
        r["frames_per_s_1"] = fps(SV_FPS_THREADS)
    finally:
        if scaler is not None:
            scaler.stop()
        ps.stop()
    print(f"service ({report['device']}) process replicas: 2 on cuda:0 in "
          f"{r['start_2_s']:.3f} s; {SV_POOL_BATCHES} batches = the "
          "in-process forward byte for byte, zero client-visible errors "
          f"across a SIGKILL (reap {r['kill']['kill_to_reap_s']:.3f} s, "
          f"readmit {r['kill']['kill_to_readmit_s']:.3f} s after the kill); "
          f"round trip p50 {r['rtt_p50_ms']:.3f} ms; "
          f"{r['frames_per_s_2']:.1f} frames/s with 2 replicas, "
          f"{r['frames_per_s_1']:.1f} with 1 ({SV_FPS_THREADS} client "
          f"threads); autoscaler 2 -> 3 in {r['scale_out_s']:.3f} s, idle "
          f"-> 2; fleet-merged {SV_SERIES} count {r['fleet_requests']} = "
          "the replicas' own")
    return r


def sv_admission(report: dict) -> dict:
    """(e) two bad lines refused at registration."""
    from nnstreamer_tpu_torch.service import AdmissionRejected, ServiceManager

    lines = {
        "NNL003": "tensor_src dimensions=3:224:224:4 types=uint8 "
                  "num-buffers=1 ! other/tensors,types=float32 ! "
                  "tensor_sink",
        "NNL001": "tensor_src num-buffers=1 ! tensor_filtr model=x ! "
                  "tensor_sink"}
    mgr = ServiceManager()
    r = {}
    try:
        for code, line in lines.items():
            try:
                mgr.register(f"bad-{code}", line)
            except AdmissionRejected as e:
                r[code] = sorted({d.rule for d in e.diagnostics})
            else:
                fail(f"service admission: a line with {code} was admitted")
            if r[code] != [code]:
                fail(f"service admission: refused with {r[code]}, expected "
                     f"[{code}]")
    finally:
        mgr.shutdown()
    print(f"service ({report['device']}) admission: a caps mismatch and an "
          "unknown element refused with AdmissionRejected (NNL003, NNL001)")
    return r


def phase_service(report: dict, prompts, want) -> None:
    """Phase 18: the service plane (module docstring)."""
    import tempfile

    r = report["service"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        r["lm"] = sv_managed_lm(report, prompts, want, Path(tmp))
    frames = sv_frames()
    fwd = sv_forwards(frames)
    r.update(sv_swap_canary(report, frames, fwd))
    r["procs"] = sv_procreplicas(report, frames, fwd)
    r["admission"] = sv_admission(report)


def phase_service_alone(report: dict) -> None:
    """--only service: the kernels built, phase 4's requests served locally
    for the reference tokens, then phase 18."""
    phase_build(report)
    prompts, want = phase_slice(report)
    phase_service(report, prompts, want)


# -- phase 19: training, MoE and the parallel layer ---------------------------

TR_BATCH, TR_SEQ, TR_STEPS, TR_LR = 8, 512, 5, 1e-2
# float32 (TF32 off) vs float64 on the card, step 0 of the same weights:
# the loss within a relative 1e-5; the whole gradient (every leaf as one
# vector) within a relative L2 error of 1e-2 and each leaf within 5e-2.
# At init the softmax over 32000 words is near uniform, so a weight's
# gradient is a small residual of per-token terms that cancel over 4096
# tokens and 12 layers: float32 gets it to about 1e-3 of its norm at this
# width (every op alone, forward and backward, is within 4e-6 of float64
# on the card), where a wrong term or scale would be off by order 1
TR_LOSS_RTOL, TR_GRAD_RTOL, TR_LEAF_RTOL = 1e-5, 1e-2, 5e-2
# the MoE serving line: 3 requests of (8, 128), 64 steps each
MOE_PROMPT = 128
# tensor_trainer: samples an epoch (train + validation), batch; the resumed
# run's loss history against the uninterrupted run's, relative (the
# embedding's backward adds with atomics: not bit for bit)
TT_TRAIN, TT_VAL, TT_BATCH, TT_RTOL = 32, 8, 8, 1e-3
TT_CONFIG = ROOT / "nnstreamer_tpu_torch" / "models" / "lm_train.py"


def tr_tokens(vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (TR_BATCH, TR_SEQ + 1)).astype(np.int32)


def tr_grad_errs(got, want) -> tuple:
    """(whole-gradient relative L2 error, {leaf: relative L2 error})."""
    from nnstreamer_tpu_torch.utils.tree import tree_named

    num = den = 0.0
    per = {}
    for (name, a), (_, b) in zip(tree_named(got), tree_named(want)):
        d = float(torch.linalg.vector_norm(a.double() - b.double())) ** 2
        n = float(torch.linalg.vector_norm(b.double())) ** 2
        num, den = num + d, den + n
        per[name] = (d / n) ** 0.5 if n else (0.0 if d == 0 else float("inf"))
    return (num / den) ** 0.5, per


def tr_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-300))


class tr_routing:
    """Wraps parallel/moe.py's ``_route`` for a block: ``record`` keeps
    each call's expert choice, keep mask and top-2 router probability gap;
    ``force`` replays recorded choices (the float64 reference takes the
    float32 run's discrete routing, since the two may break a near tie
    apart) and counts the calls' tokens whose own argmax differs."""

    def __init__(self, mode: str, store: Optional[list] = None):
        import nnstreamer_tpu_torch.parallel.moe as M

        self.M, self.mode = M, mode
        self.store = store if store is not None else []
        self.flipped = 0

    def __enter__(self):
        orig = self.orig = self.M._route
        calls = iter(list(self.store)) if self.mode == "force" else None

        def route(params, xt, C_, lead_shape, mesh=None, token_axes=()):
            out = orig(params, xt, C_, lead_shape, mesh, token_axes)
            logits, gate, expert, onehot, pos, keep = out
            if self.mode == "record":
                top = torch.topk(torch.softmax(logits.detach(), -1), 2).values
                self.store.append({"expert": expert.clone(),
                                   "dropped": (~keep).sum(),
                                   "gap": (top[:, 0] - top[:, 1]).min()})
                return out
            want = next(calls)["expert"]
            self.flipped += int((want != expert).sum())
            probs = torch.softmax(logits, -1)
            gate = probs.gather(-1, want[:, None])[:, 0]
            onehot = torch.nn.functional.one_hot(want, logits.shape[-1]).to(
                onehot.dtype)
            pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1).long()
            return logits, gate, want, onehot, pos, pos < C_

        self.M._route = route
        return self

    def __exit__(self, *exc):
        self.M._route = self.orig


def tr_step_check(name: str, cfg, dev: torch.device) -> dict:
    """(a)/(b): step 0 against float64, then TR_STEPS SGD steps."""
    from nnstreamer_tpu_torch.models.transformer import (
        init_params, loss_and_grads, make_train_step, tree_leaves, tree_map)

    params = init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(tr_tokens(cfg.vocab)).to(dev)
    moe = cfg.moe_experts > 0
    rec = tr_routing("record")
    if moe:
        with rec:
            loss32, g32 = loss_and_grads(cfg, params, toks)
    else:
        loss32, g32 = loss_and_grads(cfg, params, toks)
    p64 = tree_map(lambda p: p.double(), params)
    force = tr_routing("force", rec.store)
    if moe:
        with force:
            loss64, g64 = loss_and_grads(cfg, p64, toks)
    else:
        loss64, g64 = loss_and_grads(cfg, p64, toks)
    loss_err = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    grad_err, per_leaf = tr_grad_errs(g32, g64)
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:3]
    del p64, g64, g32
    if not loss_err <= TR_LOSS_RTOL or not grad_err <= TR_GRAD_RTOL \
            or not worst[0][1] <= TR_LEAF_RTOL:
        fail(f"train {name}: step 0 vs float64: loss rel err {loss_err:.3e} "
             f"(<= {TR_LOSS_RTOL}), gradient rel L2 {grad_err:.3e} (<= "
             f"{TR_GRAD_RTOL}), worst leaves {worst} (<= {TR_LEAF_RTOL})")
    step, _, _ = make_train_step(cfg, None, lr=TR_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(TR_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, loss = step(params, toks)
        e1.record()
        e1.synchronize()
        losses.append(float(loss))
        ms.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        fail(f"train {name}: losses {losses} not finite and decreasing")
    if not all(p.is_cuda for p in tree_leaves(params)):
        fail(f"train {name}: parameters left the card")
    steady = statistics.mean(ms[1:])
    r = {"losses": losses, "step_ms": ms, "step_ms_steady": steady,
         "tokens_per_s": TR_BATCH * TR_SEQ / (steady / 1e3),
         "peak_bytes": peak, "loss_rel_err_f64": loss_err,
         "grad_rel_l2_f64": grad_err, "worst_leaves_f64": worst,
         "parameters": sum(p.numel() for p in tree_leaves(params))}
    if moe:
        per_call = [int(c["dropped"]) for c in rec.store]
        r["dropped_tokens_step0"] = per_call
        r["routing_flips_f64"] = force.flipped
        aux_cfg = replace(cfg, moe_aux_weight=0.0)
        from nnstreamer_tpu_torch.models.transformer import loss_fn
        with torch.no_grad():
            r["aux_term_step5"] = float(loss_fn(cfg, params, toks)) - float(
                loss_fn(aux_cfg, params, toks))
    print(f"train {name} ({cfg.layers} layers, dim {cfg.dim}, "
          f"{r['parameters']} parameters, f32, TF32 off): step 0 vs float64 "
          f"loss rel err {loss_err:.3e}, gradient rel L2 {grad_err:.3e}, "
          f"worst leaves {[(k, '%.2e' % v) for k, v in worst]}; losses "
          f"{['%.6f' % x for x in losses]}; "
          f"step {steady:.3f} ms (steps 2-{TR_STEPS}, CUDA events) = "
          f"{r['tokens_per_s']:.1f} tokens/s; peak {peak} bytes"
          + (f"; dropped tokens at step 0 by layer {r['dropped_tokens_step0']}"
             f", aux term {r['aux_term_step5']:.6f}, routing flips in the "
             f"float64 pass {force.flipped}" if moe else ""))
    return r


def tr_kernel_launches() -> dict:
    from nnstreamer_tpu_torch.ops.depthwise_fma import depthwise_fma
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm

    return {**read_launches(), "fma_gemm": fma_gemm.launches,
            "depthwise_fma": depthwise_fma.launches}


def tr_reset_launches() -> None:
    from nnstreamer_tpu_torch.ops.depthwise_fma import depthwise_fma
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm

    reset_launches()
    fma_gemm.launches = depthwise_fma.launches = 0


def tr_moe_serving(dev: torch.device) -> dict:
    """(c) the MoE ``base`` entry serving 3 requests through the filter
    line (both kernels), against the dense path's greedy tokens."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.models.decoding import (
        decode_step, init_cache, prefill)
    from nnstreamer_tpu_torch.models.lm_serving import base_moe
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    cfg = base_moe.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (8, MOE_PROMPT)).astype(np.int32)
               for _ in range(REQUESTS)]
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={MOE_PROMPT}:8,types=int32 ! tensor_filter "
        "framework=torch model=nnstreamer_tpu_torch.models.lm_serving:base_moe"
        f" name=f ! tensor_sink name=out max-stored={REQUESTS}")
    outs, t_out = [], []

    def on_data(buf):
        torch.cuda.synchronize()
        t_out.append(time.perf_counter())
        outs.append(buf.tensors[0])

    pipe.get("out").connect(on_data)
    rec = tr_routing("record")
    tr_reset_launches()
    t0 = time.perf_counter()
    with rec:
        pipe.play()
        try:
            for p in prompts:
                pipe.get("in").push_buffer(p)
            pipe.get("in").end_of_stream()
            msg = pipe.wait(timeout=600)
        finally:
            pipe.stop()
    launches = tr_kernel_launches()
    if msg.type is not MessageType.EOS or len(outs) != REQUESTS:
        fail(f"train moe serving: {msg}, {len(outs)} outputs")
    check_launches("train moe serving", {k: launches[k] for k in (
        "decode_attention", "flash_attention")}, cfg.layers)
    if launches["fma_gemm"] or launches["depthwise_fma"]:
        fail(f"train moe serving: tflite kernels launched {launches}")
    gap = min(float(c["gap"]) for c in rec.store)
    # the dense path on the same weights, replaying the filter run's
    # routing (recorded call by call: a prefill and STEPS - 1 decode steps
    # a request, one call a layer each), teacher-forced on the filter's
    # tokens: each token must be the dense path's argmax, but at a near
    # tie of its logits
    per = cfg.layers * STEPS
    if len(rec.store) != REQUESTS * per:
        fail(f"train moe serving: {len(rec.store)} routing calls, expected "
             f"{REQUESTS * per}")
    params = base_moe.build_params(dev)
    cfg_d = replace(cfg, decode_attn="dense", prefill_attn="dense")
    ties, flips = [], 0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if not (o.is_cuda and tuple(o.shape) == (8, MOE_PROMPT + STEPS)):
            fail(f"train moe serving: output {tuple(o.shape)} on {o.device}")
        got = o.cpu().numpy()
        if not np.array_equal(got[:, :MOE_PROMPT], p):
            fail("train moe serving: prompt not echoed unchanged")
        force = tr_routing("force", rec.store[i * per:(i + 1) * per])
        with force, torch.inference_mode():
            cache = init_cache(cfg_d, 8, params["embed"].dtype, dev)
            logits, cache, pos = prefill(
                cfg_d, params, torch.from_numpy(p).to(dev), cache)
            for j in range(STEPS):
                if j:
                    tok = torch.from_numpy(got[:, MOE_PROMPT + j - 1]).to(dev)
                    logits, cache = decode_step(cfg_d, params, tok,
                                                pos + j - 1, cache)
                top = torch.topk(logits.float(), 2)
                want = top.indices[:, 0].cpu().numpy()
                margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
                for b in np.nonzero(want != got[:, MOE_PROMPT + j])[0]:
                    if not margin[b] < CS_TIE_MARGIN:
                        fail(f"train moe serving request {i} row {b}: token "
                             f"{j} is {got[b, MOE_PROMPT + j]}, the dense "
                             f"path's {want[b]} (top-2 margin {margin[b]})")
                    ties.append({"request": i, "row": int(b), "step": j,
                                 "margin": float(margin[b])})
        flips += force.flipped
    wall = t_out[-1] - t_out[0]
    r = {"launches": launches, "ties": ties, "least_router_gap": gap,
         "routing_disagreements_dense": flips,
         "dropped_tokens": sum(int(c["dropped"]) for c in rec.store),
         "tokens_per_s_steady": (REQUESTS - 1) * 8 * STEPS / wall,
         "first_request_s_incl_model_build": t_out[0] - t0}
    print(f"train moe serving: {REQUESTS} x (8, {MOE_PROMPT}) -> {STEPS} "
          "tokens through lm_serving:base_moe, each the dense path's argmax "
          "on the same prefix and routing"
          f"{' but at ' + str(len(ties)) + ' near ties' if ties else ''}; "
          f"launches {launches}; {r['tokens_per_s_steady']:.1f} tokens/s "
          f"(requests 2-3); least router gap {gap:.3e}, {flips} routing "
          "decisions the dense path would take otherwise; tokens dropped "
          f"over capacity {r['dropped_tokens']}")
    return r


def tt_run(epochs: int, ckpt_dir: Optional[str], samples) -> dict:
    """One tensor_trainer line over ``epochs`` epochs' frames."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    ck = f",ckpt_dir:{ckpt_dir},ckpt_every:2" if ckpt_dir else ""
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,num_tensors=2,"
        f"dimensions={TR_SEQ}.{TR_SEQ},types=int32.int32 ! tensor_trainer "
        f"name=t framework=optax model-config={TT_CONFIG} "
        f"custom=batch:{TT_BATCH},optimizer:adamw{ck} "
        f"num-training-samples={TT_TRAIN} num-validation-samples={TT_VAL} "
        f"epochs={epochs}")
    t0 = time.perf_counter()
    pipe.play()
    try:
        backend = pipe.get("t").backend
        for _ in range(epochs):
            for s in samples:
                pipe.get("in").push_buffer([s[:-1], s[1:]])
        pipe.get("in").end_of_stream()
        # the completion message comes before the EOS, which wait() takes
        done = pipe.bus.wait_for((MessageType.ELEMENT, MessageType.ERROR),
                                 timeout=600)
        wall = time.perf_counter() - t0
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    if done is None or done.type is not MessageType.ELEMENT \
            or done.data["event"] != "training-complete" \
            or msg.type is not MessageType.EOS:
        fail(f"train tensor_trainer: {done}, {msg}")
    if not all(p.is_cuda for p in backend._opt.param_groups[0]["params"]):
        fail("train tensor_trainer: parameters not on the card")
    return {"losses": list(backend.losses),
            "accuracies": list(backend.accuracies),
            "validation_loss": done.data["validation_loss"],
            "epochs": done.data["epochs"], "wall_s": wall}


def tr_trainer() -> dict:
    """(d) tensor_trainer on the base LM: 2 epochs with a checkpoint, a
    resume to 4, against an uninterrupted 4-epoch run."""
    import tempfile

    from nnstreamer_tpu_torch.models.lm_serving import base

    samples = np.random.default_rng(1).integers(
        0, base.cfg.vocab, (TT_TRAIN + TT_VAL, TR_SEQ + 1)).astype(np.int32)
    with tempfile.TemporaryDirectory() as ck:
        first = tt_run(2, ck, samples)
        resumed = tt_run(4, ck, samples)
    whole = tt_run(4, None, samples)
    if (first["epochs"], resumed["epochs"], whole["epochs"]) != (2, 4, 4):
        fail(f"train tensor_trainer: epochs {first['epochs']}, "
             f"{resumed['epochs']}, {whole['epochs']}")
    if resumed["losses"][:2] != first["losses"]:
        fail("train tensor_trainer: the resumed run lost the history")
    err = max(abs(a - b) / abs(b) for a, b in zip(
        resumed["losses"] + [resumed["validation_loss"]],
        whole["losses"] + [whole["validation_loss"]]))
    if not err <= TT_RTOL or not whole["losses"][-1] < whole["losses"][0]:
        fail(f"train tensor_trainer: resumed {resumed['losses']} vs whole "
             f"{whole['losses']} (rel err {err:.3e} > {TT_RTOL}) or no "
             "decrease")
    n = (TT_TRAIN + TT_VAL) * 4
    r = {"first": first, "resumed": resumed, "whole": whole,
         "loss_rel_err": err, "samples_per_s_whole": n / whole["wall_s"]}
    print(f"train tensor_trainer (base LM, adamw, batch {TT_BATCH}, "
          f"{TT_TRAIN} + {TT_VAL} samples an epoch): 2 epochs + resume to 4 "
          f"= the uninterrupted 4 within rel {err:.3e}; losses "
          f"{['%.5f' % x for x in whole['losses']]}; validation loss "
          f"{whole['validation_loss']:.5f}; {r['samples_per_s_whole']:.1f} "
          "samples/s over the whole line (model build included)")
    return r


def tr_parallel(dev: torch.device) -> dict:
    """(e) a world-1 NCCL group: meshed steps (ring, ulysses, gspmd) and a
    1-stage pipeline against the meshless runs."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models.lm_serving import base
    from nnstreamer_tpu_torch.models.transformer import (
        init_params, make_train_step, tree_leaves)
    from nnstreamer_tpu_torch.parallel import init_multihost, make_mesh
    from nnstreamer_tpu_torch.parallel.pipeline import (
        make_pipeline, stack_stage_params)

    init_multihost(f"127.0.0.1:{sv_free_port()}", 1, 0)
    r: dict = {"backend": dist.get_backend()}
    try:
        if r["backend"] != "nccl":
            fail(f"train parallel: backend {r['backend']}, expected nccl")
        mesh = make_mesh(None, {"dp": 1, "tp": 1, "sp": 1})
        cfg = base.cfg
        params = init_params(cfg, seed=0, device=dev)
        toks = tr_tokens(cfg.vocab)
        step0, _, _ = make_train_step(cfg, None, lr=TR_LR)
        want, want_loss = step0(params, torch.from_numpy(toks).to(dev))
        want_d = [w - p for w, p in zip(tree_leaves(want),
                                        tree_leaves(params))]
        del want
        for impl in ("ring", "ulysses", "gspmd"):
            step, shard, sharding = make_train_step(
                replace(cfg, attn_impl=impl), mesh, lr=TR_LR)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            p, t = shard(params), sharding(toks)
            e0.record()
            got, loss = step(p, t)
            e1.record()
            e1.synchronize()
            loss_err = abs(float(loss) - float(want_loss)) / float(want_loss)
            d_err, per = tr_grad_errs(
                [g - q for g, q in zip(tree_leaves(got), tree_leaves(params))],
                want_d)
            del got
            if not loss_err <= TR_LOSS_RTOL or not d_err <= TR_GRAD_RTOL \
                    or not max(per.values()) <= TR_LEAF_RTOL:
                fail(f"train parallel {impl}: loss rel err {loss_err:.3e}, "
                     f"update rel L2 {d_err:.3e}, worst leaf "
                     f"{max(per.values()):.3e} vs the meshless step")
            r[impl] = {"loss_rel_err": loss_err, "update_rel_l2": d_err,
                       "update_rel_l2_worst_leaf": max(per.values()),
                       "step_ms": e0.elapsed_time(e1)}
        # a 1-stage GPipe over the pp axis: block 0's MLP on 4 microbatches
        mesh_pp = make_mesh(None, {"pp": 1})
        blk = params["blocks"][0]
        stage = {"w1": blk["w1"], "w2": blk["w2"]}

        def stage_fn(q, x):
            return x + torch.relu(x @ q["w1"]) @ q["w2"]

        g = torch.Generator(device=dev).manual_seed(5)
        xs = torch.randn((4, 2, TR_SEQ, cfg.dim), generator=g, device=dev)
        run = make_pipeline(stage_fn, 1, mesh_pp)
        stacked = {k: v.detach().requires_grad_(True) for k, v in
                   stack_stage_params([stage]).items()}
        ys = run(stacked, xs)
        gp = torch.autograd.grad((ys ** 2).mean(), list(stacked.values()))
        plain = {k: v.detach().requires_grad_(True) for k, v in stage.items()}
        yd = torch.stack([stage_fn(plain, x) for x in xs])
        gd = torch.autograd.grad((yd ** 2).mean(), list(plain.values()))
        out_err = tr_rel_l2(ys.detach(), yd.detach())
        grad_err = max(tr_rel_l2(a[0], b) for a, b in zip(gp, gd))
        if not out_err <= 1e-6 or not grad_err <= 1e-6:
            fail(f"train parallel pipeline: outputs rel {out_err:.3e}, grads "
                 f"rel {grad_err:.3e} vs the plain stage")
        r["pipeline"] = {"out_rel_l2": out_err, "grad_rel_l2": grad_err}
    finally:
        dist.destroy_process_group()
    print(f"train parallel (world of 1, {r['backend']}): meshed steps equal "
          "the meshless one — "
          + "; ".join(f"{k} loss rel {r[k]['loss_rel_err']:.2e}, update rel "
                      f"{r[k]['update_rel_l2']:.2e}, "
                      f"{r[k]['step_ms']:.1f} ms"
                      for k in ("ring", "ulysses", "gspmd"))
          + f"; 1-stage pipeline outputs rel {r['pipeline']['out_rel_l2']:.1e}"
          f", grads rel {r['pipeline']['grad_rel_l2']:.1e}")
    return r


def phase_train(report: dict, dev: torch.device) -> None:
    """Phase 19: training, MoE and the parallel layer (module
    docstring)."""
    from nnstreamer_tpu_torch.models.lm_serving import base

    if torch.backends.cuda.matmul.allow_tf32:
        fail("train: TF32 is on")
    r = report["train"] = {}
    r["dense"] = tr_step_check("base dense", base.cfg, dev)
    torch.cuda.empty_cache()
    r["moe"] = tr_step_check("base moe8", replace(base.cfg, moe_experts=8),
                             dev)
    torch.cuda.empty_cache()
    r["moe_serving"] = tr_moe_serving(dev)
    torch.cuda.empty_cache()
    r["trainer"] = tr_trainer()
    torch.cuda.empty_cache()
    r["parallel"] = tr_parallel(dev)


def phase_train_alone(report: dict) -> None:
    """--only train: the kernels built, then phase 19."""
    phase_build(report)
    phase_train(report, ST_DEV)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import nnstreamer_tpu_torch
    except ImportError as e:
        fail(f"the nnstreamer_tpu_torch package is not beside this script: {e}")
    if ROOT not in Path(nnstreamer_tpu_torch.__file__).resolve().parents:
        fail("nnstreamer_tpu_torch was imported from outside this checkout")
    # full float32 products in both the kernel checks and the model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report: dict = {}
    dev = ST_DEV
    report["device"] = phase_device()
    alone = {"fusion": phase_fusion, "streams": phase_streams,
             "plugins": phase_plugins, "tflite": phase_tflite,
             "query": phase_query_alone, "service": phase_service_alone,
             "train": phase_train_alone, "trace-loss": phase_trace_loss}
    if len(sys.argv) == 3 and sys.argv[1] == "--only" \
            and sys.argv[2] in alone:
        # phase 13, 14, 15, 16, 17, 18 or 19 alone (no kernel is checked,
        # no ok line), or the trace-loss count
        alone[sys.argv[2]](report)
        print(json.dumps(report[sys.argv[2]], default=str))
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]} (run with none, or with "
             "--only fusion / streams / plugins / tflite / query / service "
             "/ train for phase 13 / 14 / 15 / 16 / 17 / 18 / 19 alone, or "
             "--only trace-loss)")
    phase_build(report)
    decode_t = phase_kernels(report, dev)
    flash_t = phase_flash(report, dev)
    prompts, filter_outs = phase_slice(report)
    launches = phase_generate(report, prompts, filter_outs)["launches"]
    phase_parity(report, dev)
    phase_conversation(report, dev)
    phase_mobilenet_model(report, dev)
    phase_mobilenet_lines(report)
    phase_video_line(report)
    cont = phase_continuous(report, dev)
    phase_zoo(report, dev)
    phase_obs(report, prompts, filter_outs,
              {"decode_attention": decode_t, "flash_attention": flash_t})
    phase_fusion(report)
    phase_streams(report)
    phase_plugins(report)
    phase_tflite(report)
    phase_query(report, prompts, filter_outs)
    phase_service(report, prompts, filter_outs)
    phase_train(report, dev)

    def line(name, source, replaces, timings):
        t = timings[str(torch.float32)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "launches_continuous": cont["dense"]["launches"][name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    # launches: the tensor_generate path's run (the filter path's, equal,
    # is checked in phase 4) and the continuous dense engine's run (phase
    # 10); times: the float32 main path's shapes
    kernels = [
        line("decode_attention",
             "nnstreamer_tpu_torch/csrc/decode_attention.cu",
             "nnstreamer_tpu/ops/pallas_decode.py:83", decode_t),
        line("flash_attention",
             "nnstreamer_tpu_torch/csrc/flash_attention.cu",
             "nnstreamer_tpu/ops/pallas_attention.py:89", flash_t),
    ]
    # the decode row also carries its per-slot-position timing (phase 10)
    slot = cont["slot_kernel"][str(torch.float32)]
    kernels[0]["per_slot_pos"] = {k: slot[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    # both LM kernels again in the query server's process (phase 17) and
    # in the managed service's serve process (phase 18)
    for k in kernels:
        k["launches_query"] = report["query"]["lm"]["launches"][k["name"]]
        k["launches_service"] = \
            report["service"]["lm"]["launches"][k["name"]]
    # the fake-quant conv order (phase 16): replaces no Pallas kernel but
    # the reference's XLA conv; launches from the fake-quant line's run,
    # times and bound for one batch-64 forward's launches, each at its shape
    fq = report["tflite"]["fma_gemm"]
    kernels.append({
        "name": "fma_gemm", "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/fma_gemm.cu",
        "replaces": "nnstreamer_tpu/models/tflite_import.py:502",
        "launches": report["tflite"]["fma_gemm_launches"],
        **{k: fq[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}})
    # the fake-quant depthwise order (phase 16): replaces no Pallas kernel
    # but the reference's jitted depthwise_shift_add; as fma_gemm's row
    dq = report["tflite"]["depthwise_fma"]
    kernels.append({
        "name": "depthwise_fma", "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/depthwise_fma.cu",
        "replaces": "nnstreamer_tpu/models/tflite_import.py:150",
        "launches": report["tflite"]["depthwise_fma_launches"],
        **{k: dq[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}})
    # every kernel's launches on the MoE serving line (phase 19c)
    for k in kernels:
        k["launches_moe"] = \
            report["train"]["moe_serving"]["launches"][k["name"]]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
