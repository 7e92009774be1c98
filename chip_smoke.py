#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``crowdllama_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase multiprocess   # that phase alone
    python3 chip_smoke.py --phase gemma2   # the Dh-256 kernel line and
                                           # engine_gemma2_9b alone
    python3 chip_smoke.py --phase distill_gemma2   # the Dh-256 kernel
                                   # line and distill_gemma2_9b alone
    python3 chip_smoke.py --phase danube   # the Dh-80 and Dh-96 kernel
                          # lines, engine_danube_1_8b and its cuts alone

Phases, each printing one JSON line:

1. device: the card's name, compute capability (must be 9.0) and
   ``nvidia-smi`` name/power limit;
2. build: compiles every kernel from ``crowdllama_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once; each attention kernel, the fp32
   entries too, at head dims 64, 128 and 256, the bf16 and int8 ones also
   at 80 and 96) and reports the seconds it took, each instantiation's
   registers and spills from ``ptxas -v``, and each entry's dynamic
   shared memory and blocks per SM at the serving groups (8 query heads a
   kv head at Dh 64, 4 at Dh 128, 2 at Dh 256, 4 at Dh 80 and 96);
   native: the native data plane (``crowdllama_tpu_torch/native``)
   built from the checkout's C++ source with g++ (a failure is an
   error), then seal and open of one 64 KiB and one 256 KiB (``CHUNK``)
   frame, the native session against the Python ChaCha20-Poly1305 in
   this process, byte-equal, median host us of each;
3. threefry: the port's threefry keys and bits, and its samplers on logits
   on the card (rows with tied logits too), against golden vectors
   captured from JAX (``engine/prng_golden.py``);
4. kernels, once at Dh 64 over TinyLlama's 32 / 4 heads, once at Dh 128
   over Llama-3-8B's 32 / 8, once at Dh 256 over Gemma-2-9b's 16 / 8, once
   at Dh 80 over H2O-Danube-1.8B's 32 / 8 and once at Dh 96 over the same
   heads (A also at qwen2.5-7b's group of 7, 28 / 4 heads, at all five;
   the fp32 entries below only at Dh 64, 128 and 256): each
   hand-written kernel (A prefill, B paged decode, C ragged paged, D
   contiguous decode, E one prefill chunk over its slot's pages, F paged
   decode on tensor-parallel shares of the heads, and B, C, E and F on
   int8 pools with bf16 scales from ``quantize_kv``) against its
   plain PyTorch version on the same inputs — at the serving shapes
   TinyLlama-1.1B gives it, and at small shapes with softcap, a sliding
   window and all-masked rows or zero-length slots (B, B-int8, D, F and
   F-int8 also at lengths on the edges of their split-KV plan, 256 keys a
   split: 0, 1, 127, 128, 129, 256, 257 and the table's or cache's 2,048,
   with windows that leave whole splits empty, two calls equal; C and E
   also at a context that is not page-aligned, a window across a page
   boundary, a chunk that is not a multiple of a block's queries and, for
   E, a group of 7 query heads per kv head) — with times for the
   kernel, the plain version, one PyTorch SDPA call over the same
   (gathered; for int8, dequantized to bf16) inputs and the card's least
   time for the work (its bound).  F at tp 2 and 4 must equal B on the
   whole pool bit for bit.  The fp32 entries of A and D (the
   distillation trainer's: fp32 in, fp32 out; A's products 3xTF32 on the
   tensor cores, D's fp32 FMAs) at all three head dims against their plain
   versions on fp32 inputs at atol and rtol 1e-5, on the same shapes (A
   also at a group of 7) and on the shapes the distill phase gives them
   (A at 16 x 64 tokens, D over 64 slots of a 64-key cache at lengths
   1-64), with their bounds (D's at the card's fp32 rate, A's at a third
   of the TF32 rate, the rate of its 3xTF32 products, with the fp32 rate's
   beside it, ``bound_fp32_fma_ms``) and one SDPA call in fp32 under
   the fastest backend that takes it (flash and cuDNN refuse fp32; the
   backend is named);
4a. kernel_G (its own line): kernel G, the grouped GEMM over an expert
   bank (``csrc/grouped_gemm.cu``; no Pallas counterpart: it stands in for
   ``lax.ragged_dot`` and ``qeinsum``'s dequant), on bf16, int8 and int4
   banks against its plain version within 0.0156 of the output's scale:
   Mixtral's decode shapes (8 experts, 2 rows a token at 1, 8 and 64
   tokens, hidden 4096 -> 14336 and back, the rows routed at random so
   some experts get none, and 16 rows all on one expert), one prefill of
   1,024 tokens, llama-3-8b's dense products (E 1 at 8 and 512 rows);
   each with the kernel's, the plain version's and the bound's ms (the
   touched experts' weight and scale bytes plus the rows at 3.35 TB/s,
   or 2 * rows * K * N at 989 TF/s) and, for bf16, one library call's
   (``torch._grouped_mm``, or ``torch.matmul`` at E 1; at E 1 for int8
   ``torch._weight_int8pack_mm`` and for int4 ``torch._weight_int4pack_mm``
   on the bank repacked once, where this torch has a CUDA kernel for it,
   else "none" and why; no call dequantises per expert, so the grouped
   int8 and int4 cases have no yardstick); each case names the schedule the
   plan chose from its shapes (``stream``: register dequantisation and
   split K; ``wgmma``: 128-row passes of wgmma tiles), its split factor,
   grid and (streaming) wave of resident blocks, and the line carries
   each schedule's shared memory and blocks an SM (the streaming ones
   must equal the plan's ``STREAM_BLOCKS_PER_SM``);
5. engine: ``TorchEngine`` serving tinyllama-1.1b at full width (random
   weights from seed 0, default config: 8 slots, page 128, context 2048)
   to 8 concurrent greedy ``generate()`` streams — 6 short prompts, one
   prompt that repeats a served prompt's first 300 bytes (prefix cache) and
   one of ~1,500 bytes sent while the others decode (unified ragged
   prefill).  Launch counts are zeroed right before the streams are sent
   and read right after; kernels A-C must have launched, no other.  Then
   one prefill, one decode step and one ragged step run through the
   kernels and through the plain versions, and their logits must agree;
   the long prompt's TTFT is reported beside the time of each ragged step
   of a long prompt prefilled beside 3 decoding slots (and its kernel C
   time, CUDA events);
   megastep (run here, printed after the wire line): the same engine
   with ``megastep_k=8`` (decode_chunk 8): each full decode chunk one
   replay of a CUDA graph captured at warm-up (kernel B inside it), the
   ragged megastep eager (C).  First its sub-phases, 2 greedy prompts of
   16 tokens each, eager then under megastep on one engine,
   token-identical: paged int8 (B-int8), contiguous (D), tp=2 on the
   card (F), llama-3-8b cut to 4 layers (``reduced``).  Then the paged
   phase's streams (and the seeded one) sent at once, eagerly and then
   under megastep on one engine: token-identical, the seeded stream
   repeating alone; B launches 22 times a decode step, C 22 times a
   ragged step (ragged_mega flights among them), no capture while
   serving; the duty-cycle gauges; one flight graph against eager (the
   done-flags where ``_emit`` retires); host ms per step, graph replay
   against eager, in 5 alternated pairs; 5 captures (seconds, pool
   bytes); the busy share over 1 s while 4 streams decode (CUDA events
   around each replay) beside the wire phase's eager one; then a
   ``megastep_profile`` line: device time and top kernels and operators
   of one graph flight and one eager chunk (``torch.profiler``).  Every
   graph capture of the run precedes its first profiler session;
6. wire: the worker's request seam on tinyllama-1.1b (paged, bf16, the
   same seed-0 weights): the port's ``IPCServer`` on a Unix socket, a
   client speaking only the port's llama.v1 codec; a PB greedy request
   equal to a direct ``generate()``, a seeded one that repeats, a JSON
   prompt of the long prompt, a JSON embed equal to ``embed_prompts``,
   ping, status, an oversized frame (dropped, the server keeps serving);
   the golden frames of ``core/wire_golden.py``; one request streamed
   through ``handle_streaming_frames``; an IPC ``profile`` of 1 s while 4
   streams decode (the trace's top kernels and the card's busy share:
   the union of kernel intervals over the window); last ``migrate()``
   under 3 streams (MigrateFrames with their delivered tokens and chain
   hashes, the pool idle, new requests refused).  A, B and C launch, no
   other; the host us to encode and decode one frame;
   swarm (on the wire phase's engine, before its migrate, its own line):
   the worker's swarm plane, every module the port's own — a DHT
   bootstrap node, a worker ``Peer`` over the engine, a client host with
   its own key on loopback.  The ``crypto_golden`` vectors (X25519,
   Ed25519, ChaCha20-Poly1305, HKDF: the bytes ``cryptography`` gives)
   on this Python; the client discovers the worker through the DHT (its
   metadata names the card as ``gpu_model`` and the model), times the
   signed handshake, then sends the greedy request (streamed) and the
   seeded request over one pooled secure stream: both token for token a
   direct ``generate()``, the second with no new handshake.  Kernels A
   and B must launch in the phase; host ms of each request beside the
   direct ``generate()``, and us to seal one streamed frame;
   cli: ``python -m crowdllama_tpu_torch.cli.main start --worker-mode``
   (tinyllama-1.1b, random weights) in its own process joins this
   process's DHT node, answers one request over a secure stream from a
   worker whose metadata names the card; beside it ``start`` (a
   consumer with its gateway on ``--gateway-port``) in a process of its
   own: the CLI's ``network-status`` names the worker healthy and ``run
   <model> "<prompt>"`` prints through that gateway the text a greedy
   ``/api/chat`` of the prompt replies; both processes exit 0 on SIGTERM;
   gateway (its own line, and a ``gateway_megastep`` line): the consumer
   side, every module the port's own, on 127.0.0.1 — a DHT node, two
   workers (eager, paged bf16, one set of seed-0 weights shared on the
   card, cut to ``GATEWAY_LAYERS`` layers (``reduced``), the unembedding
   of every id but printable ASCII zeroed so each token is a character),
   a consumer ``Peer`` and its ``Gateway``, the
   standard library's ``http.client`` as the client: greedy ``/api/chat``
   (streamed and not) and the CLI's ``run`` through this gateway,
   ``/api/generate`` equal to ``generate()``, a seeded request that
   repeats, SSE ``/v1/chat/completions``,
   ``/api/embed`` vs the runner, tags, health, /metrics, a stitched
   trace, a burst shed with ``Retry-After``, TTFB and tokens/s of 8
   concurrent chats beside 8 direct streams, host us per NDJSON frame,
   the busy share over 1 s with 4 streams through the gateway, the long
   prompt through it (kernel C), a drain at the third chunk failing over
   with the same text; A, B and C launch; then a worker with
   ``megastep_k=8`` behind the same gateway: tokens/s of 8 streams
   beside direct ``generate()`` and the AEAD's us per operation;
   kv_ship and replicated (a line each): two tinyllama workers (paged
   bf16, the gateway phase's printable weights and depth, ``kv_ship``)
   behind two
   ``Gateway`` replicas gossiping through ``GossipNode``s, all on
   127.0.0.1.  The continuation of a chat whose 1,465-token first turn
   ran on worker 1 lands on worker 2, which fetches worker 1's 11 pages
   and streams what worker 1 streams from its cache, token for token,
   kernel B launching over the imported pages; worker 2's last-position
   logits of the turn-1 prompt over the imported pages agree with a
   prefill of it from an empty cache within 5% of their scale (on int8
   pools too); the same prompt direct on
   worker 2, from an empty cache and with the donor, in 3 alternated
   pairs (TTFT, fetch ms, bytes) and the card's busy share over 1 s of
   an import; an injected ``kv.serve`` error: plain prefill, the same
   tokens, one fallback; a stream drained mid-decode on worker 1 hands
   its pages to worker 2 (0 prefill tokens replayed, the undrained
   text); then int8 pools, the same fetch with B-int8.  Replicated: the
   conversation continued through replica 2 lands on replica 1's pinned
   worker (a gossip affinity hit), ``default=1000,hot=2`` quotas shed
   the hot tenant alone on both replicas (usage gossiped), and the drain
   replica 1 saw quarantines worker 1 on replica 2 within a round;
   relay (its own line): a torch-only swarm of processes started through
   their CLIs (``cli_child``): ``python -m crowdllama_tpu_torch.cli.dht
   start`` (bootstrap node and relay), a worker ``start --worker-mode
   --relay-mode always`` (tinyllama-1.1b, seed-0 weights,
   ``--megastep-k 8``) reachable only through the relay, and per rung of
   the dial ladder a consumer ``start`` with its gateway (the three
   started at once, beside the worker): the splice, connection reversal
   and a hole punch on loopback.  Each rung: a greedy
   streamed ``/api/chat`` equal in text and tokens to a direct greedy
   ``generate()`` here on the same weights (TTFB beside its TTFT), 8
   concurrent chats, the ladder's counters and the worker's inbound
   stream kinds naming the rung; A, B and C launch on the worker; every
   process has the native plane on with no fallback and exits 0 on
   SIGTERM;
   aead_split (its own line): ``gateway_megastep`` with the gateway in
   a process of its own (a consumer ``start``), the megastep worker
   here (the gateway phase's weights and depth), once with
   ``CROWDLLAMA_NO_NATIVE=1`` on both sides and once without: per side
   AEAD operations, us per operation and share of the wall, and
   tokens/s through the gateway as a share of direct;
7. engine_int8: the same engine with ``kv_dtype="int8"`` (int8 pools)
   and the same traffic plus a seeded sampled stream (temperature 0.8,
   seed 1234) that must repeat token for token when sent again; kernels
   A, B-int8 and C-int8 must have launched and B, C (bf16) not; one
   decode step through B-int8 must agree with its plain version; the
   ragged steps and the steady step are reported, the latter beside the
   bf16 pool's;
8. contiguous: ``TorchEngine(kv_layout="contiguous")`` on the same
   weights serves 8 concurrent streams of 32 tokens — 6 greedy short
   prompts, the seeded sampled stream and the ~1,500-byte prompt sent
   while they decode (legacy chunked admission, >= 2 chunks).  Kernels A
   and D must have launched; the seeded stream must repeat; one decode
   step through kernel D must agree with the plain version;
9. contiguous_int8: the contiguous int8 cache, 4 greedy streams of 16
   tokens, the long one in legacy chunks; its decode is the plain
   ``decode_attention_q`` (no Pallas kernel in the JAX package either),
   so only kernel A may launch;
10. engine_tp: the paged engine tensor-parallel, ``mesh_shape="2"`` with
   both ranks on the one card (``devices=[cuda:0, cuda:0]``: it proves the
   sharded math and kernel F's launches, not a tp speed-up), the paged
   phase's traffic: every stream done, 22 F launches per decode step (the
   two ranks in one grid) and no B launch, A and C per rank, step logits
   kernel vs plain within 2%
   of their scale, the share of greedy tokens equal to the one-device
   phase's, the steady step and the peak memory beside that phase's
   (peak at most 1.1x);
11. engine_tp_int8: the same on int8 pools, 3 streams of 16 tokens
   (F-int8 launches, no B-int8; C-int8 per rank), one decode step vs
   plain.

12. engine_llama: llama-3-8b at full width and depth (32 layers, Dh
   128, 32 / 8 heads, hidden 4096, vocab 128256; random bf16 weights from
   seed 0 made on the card, EOS column zeroed) on the paged main path,
   the paged phase's traffic and checks (kernels A-C at Dh 128);
12a. spec (its own line): speculative decoding on tinyllama-1.1b at full
   width (22 layers, page 128, context 2,048, 8 slots).  Weights: the
   permutation weights of ``testing/modelgen.py`` (greedy decode walks a
   fixed next-id cycle with O(1) margins) on the card; a draft, the same
   weights cut to 2 layers, written by the port's ``save_params`` into a
   temporary directory, read back byte-equal and served through
   ``spec_draft_path``; the seed-0 random weights.  The plain paged
   engine serves 8 concurrent greedy streams of 64 tokens (4 prompts that
   echo a stretch of the cycle, 3 short prompts, and the ~1,500-byte
   prompt sent while they decode: kernel C); n-gram speculation on paged
   bf16 and int8 pools and on the contiguous cache (``spec_draft=4``) and
   the draft model from the checkpoint serve the same streams and give
   the same text and token ids.  Per engine: tokens per verify step, the
   accepted share by source, retunes; the echo streams verify more than
   one token a step, the draft runner accepts >= 90% of the drafts it
   offers; launches between sending the streams and their end: A and C
   (C-int8) on the paged engines, D on the draft runner, and the plain
   decode kernel (B, B-int8, D on the contiguous cache) exactly 22 times
   per step of the ``plain`` dispatch class (the flight plane's class
   steps); the ``spec`` duty cycle above 0; a seeded sampled stream
   (temperature 0.8, seed 1234) repeats.  Adaptive draft length:
   ``spec_draft=2, spec_draft_max=6`` on the echo streams grows k; the
   seed-0 random weights behind the permutation draft pause (k = 0) and
   probe, and B launches once paused.  Numerics on the random weights:
   one verify step's row-0 logits against the decode step's through B
   (and B-int8 on int8 pools) within ``LOGIT_RTOL`` of their scale.
   Times, as findings: host ms of a verify dispatch beside a plain step
   in 5 alternated pairs, the context gather's ms (CUDA events), tokens/s
   of the echo streams under n-gram and draft beside plain, peak memory.
   The pipeline: the port's ``Gateway`` with
   ``gateway_spec_pipeline="gateway"`` drafting from the checkpoint on
   the card (A and D) in front of a worker with ``spec_decode="ngram"``:
   a streamed greedy ``/api/chat`` equal to a direct ``generate()`` with
   verify rounds answered, then ``"worker"`` mode (pure ack credits)
   with the same text;
12a'. autotune (its own line): the autopilot on tinyllama-1.1b at full
   width and depth on the permutation weights (8 slots, context 2,048,
   page 128, prefix cache off), started with ``autotune=True`` and
   ``slo_decode_ms``.  ``paged`` (``megastep_k=8``): 4 short and 4 echo
   prompts of 64 tokens and the 1,465-token prompt sent while they
   decode, three passes with the tuner detached, then three with it
   (interval 2, ``min_gain`` 1e6 so every trial reverts, burn windows of
   one), the middle pass under a ``scheduler.ragged_chunk`` delay of 1 s
   at its first two ragged dispatches.  ``spec``: n-gram speculation with
   ``spec_draft_max=4`` on the echo and short prompts, interval 1.  Each:
   tuned token ids equal to the untuned ones, A, B and C (``paged``) or
   A (``spec``) launched in the tuned passes, every megastep K flown
   without a graph captured once and no graph captured twice (a revert
   replays); ``paged`` >= 3 moves, >= 1 revert, >= 1 back-off; ``spec``
   >= 2 moves, the draft cap among them.  Printed: the dial trajectory,
   each graph's capture seconds, pool bytes and whether it was captured
   mid-serve, peak memory, tokens/s tuned beside untuned (recorded, not
   claimed), the phase's seconds.  The kernel phase holds kernel C
   (bf16, Dh 64) at the chunk rows the dials give (128, 256, 384 and
   1,024: a whole chunk and the long prompt's last one each) and A at q
   1,024 at both head dims;
12a''. moe (its own line, then ``moe_bf16``, ``moe_int4``, ``moe_tp1``
   and ``moe_tp2``): mixtral-8x7b at full width and depth (32 layers, 8
   experts, top 2) with int8 weights born quantized on the card
   (``random_quantized_params``: the 93 GB bf16 tree never exists;
   ~47 GB held), paged bf16 KV at context 2,048, ``megastep_k=4``:
   the paged phase's traffic, 16 tokens, served eagerly (A, B, C and
   G-int8 launch, no other), then 2 prompts eagerly and as megastep
   flights on one engine, token-identical (the MoE forward is captured
   in a graph: no host sync); prefill, decode and ragged-step logits
   through the kernels against the plain route within ``LOGIT_RTOL``, the
   plain route taking the kernel route's expert choices (a top-k choice
   flips at near-ties; the flips it would have made are counted); the
   steady step beside its bound (every weight byte once) and G's share;
   peak memory.  Cut in depth (``reduced``): bf16 weights at 4 layers (G
   on bf16 banks), int4 at 8, and tp=2 int8 at 2 layers on the one card
   (F, G per rank) token for token with tp=1 on live permutation weights
   (``moe_live_params``);
12b. hf (its own line): HF checkpoints written by the port
   (``save_hf_checkpoint``: bf16 ``LlamaForCausalLM`` tensors in two
   shards with an index, the published ``config.json``, a
   ``tokenizer.json`` and a ``tokenizer_config.json`` with the chat
   template, from ``testing/hf_fixtures.py``) and served through
   ``TorchEngine(model=<a name outside the registry>, model_path=dir)``:
   tinyllama-1.1b at full width and depth (byte-fallback BPE,
   TinyLlama-Chat's template, the paged phase's 8 streams as chats) and
   llama-3.1-8b cut to 4 layers (llama3 rope scaling, byte-level BPE,
   Llama-3.1's template, 3 chats of 16 tokens).  Each: the config equal
   to the registry's, every tensor as written, streams token for token
   those of an engine on the same weights in memory fed the same prompt
   ids, A, B and C launched, stream deltas equal to ``decode``; load
   seconds, GB/s and the host's peak RSS;
12c. share (its own line): swarm model sharing on 127.0.0.1, every
   module the port's own (a DHT node, two workers, a consumer and its
   gateway): worker 1 serves the hf phase's tinyllama directory (2.2 GB,
   two shards) under a name outside the registry; a client times the
   ``manifest`` op (SHA-256 of every file), then sends worker 2 (empty
   ``models_dir``) the ``pull`` op: the fetch's GB/s, the hot
   registration's seconds, the pulled files' hashes equal to the
   donor's; ``/api/pull`` 200 for the model, 404 for a name nobody has;
   worker 2's first stream on the pulled model (TTFT, launches of A, B
   and C) token for token worker 1's; the CLI's ``pull`` into a third
   directory, ``list``, ``list --gateway``, ``show`` and ``rm`` as
   subprocesses, exit codes 0;
12d. distill (its own line): ``distill-draft`` through the port's CLI in
   a process of its own: tinyllama-1.1b at full width and depth in fp32
   as the teacher (seed-0 weights), a 2-layer student, ``DISTILL``'s
   shapes; rollout seconds and tokens/s, the train step's device ms
   (CUDA events), the losses and agreement; the loss falls; A's and D's
   fp32 entries launch exactly once per layer per train step and per
   rollout step, no other kernel; the step-1 gradient through A's
   ``autograd.Function`` against the plain function's on the card
   (``GRAD_RTOL``); one batch's teacher logits through A's and D's fp32
   entries against the plain route (``TEACHER_LOGIT_RTOL``); the
   checkpoint loads and drafts for the seed-0 weights in one short
   speculative stream;
12e. distill_gemma2_9b: the same with a Gemma-2-9b teacher at full width
   and all 42 layers in fp32 (head dim 256: the fp32 entries at Dh 256),
   its directory holding Google's published ``config.json`` with Hugging
   Face's default ``tie_word_embeddings`` stated, no weights (seed-0
   random init in fp32 on the card, 37 GB), ``DISTILL_GEMMA9``'s steps;
   the child's peak memory beside ``distill_memory``'s reckoning; the
   speculative stream serves Gemma-2-9b in bf16 at a 1,024-token
   context;
13. engine_llama_int8, contiguous_llama, engine_llama_tp,
   engine_llama_tp_int8: llama-3-8b cut to 4 layers at full width on
   int8 pools (B-int8, C-int8), the contiguous layout (D), tp=2 on the
   one card (F) and tp=2 on int8 pools (F-int8), 3 streams of 16 tokens
   each, one decode step (and on bf16 paged pools a prefill and a ragged
   step) vs the plain versions; the cut is printed as ``reduced``;
13b. engine_gemma2_9b: Gemma-2-9b (Google's published config: head dim 256,
   16 / 8 heads, 42 layers, a window of 4,096 on every other layer,
   softcaps, tied, context 8,192) at full width and depth on the paged
   main path, random bf16 weights from seed 0 made on the card (norm
   weights at Hugging Face's init, ``gemma2_9b_params``): the paged
   phase's short prompts and prefix hit and a ~6,000-token prompt past
   the window, 32 tokens each; A, B and C launch once a layer; logits
   through the kernels against the plain versions (5% of scale) and the
   ``rounding_probe``; the steady step, TTFT and the serving peak beside
   their predictions; then engine_gemma2_9b_int8, contiguous_gemma2_9b,
   engine_gemma2_9b_tp and engine_gemma2_9b_tp_int8 cut to 4 layers, as
   the llama cuts;
13c. engine_danube_1_8b: H2O-Danube-1.8B (its published config, read
   through ``config_from_hf_dir``: a Mistral model, head dim 80, 32 / 8
   heads, 24 layers, a window of 4,096 on every layer, untied, context
   16,384) at full width and depth on the paged main path, random bf16
   weights from seed 0 made on the card: the paged phase's short prompts
   and prefix hit and a ~6,000-token prompt past the window, 32 tokens
   each; A, B and C launch once a layer; logits through the kernels
   against the plain versions (5% of scale); the steady step, the ragged
   step with C's time, TTFT and the serving peak beside their
   predictions; then engine_danube_1_8b_int8, contiguous_danube_1_8b,
   engine_danube_1_8b_tp and engine_danube_1_8b_tp_int8 cut to 4 layers,
   as the llama cuts;
14. quant: llama-3-8b at full depth with int8 and then int4 weights
   (born quantized on the card), the paged phase's traffic, 16
   tokens: A, B, C and G (its int8 or int4 entry) launch, the logits
   through the kernels against the plain route, the steady step and G's
   share beside ``engine_llama``'s bf16 step.

15. shard_pp and shard_ep (a line each): sharded serving across workers
   (``engine/sharded.py``), all on 127.0.0.1 in this process: a DHT node,
   a two-member shard group (each member a ``ShardedEngine`` behind its
   own ``Peer``, its share drawn on the card from seed 0 piece by piece,
   never the whole tree), a consumer ``Peer`` and its ``Gateway``.
   shard_pp: gemma-2-27b at full width cut to 8 of 46 layers (``reduced``)
   in two pipeline stages of 4 (kernel A in each stage's prefill, D in its
   decode, the windows sliced by global layer index); shard_ep:
   mixtral-8x7b in bf16 at full width cut to 4 of 32 layers over two
   expert banks of 4 (A and D on the leader, G on the banks).  Two greedy
   ``/api/chat`` of 16 tokens, whole and streamed, and (pp) one n-gram
   verify chat on an echo prompt; no session left after any request; the
   leader's logits against one unsharded forward of the same weights and
   the kernel route against the plain one within ``LOGIT_RTOL`` (ep: the
   plain route replaying the kernel route's expert choices, flips
   counted); TTFT, ms per decode token split into the members' device
   time, the unembedding's and the rest, launches per token, each
   member's start and bytes held, the serving peak.

16. mesh_* (a line each): the in-mesh axes, single-controller, every
   rank on the one card (``devices=[dev] * n``).  TinyLlama at full width
   and depth on its seed-0 weights serves 3 streams of 16 tokens (2 short
   prompts and the long one) through ``TorchEngine``, first on one device
   with the contiguous layout (``mesh_base``, the line the others stand
   beside), then on each mesh with the default paged config, so that dp,
   pp and sp go through the serving plan's loud move to the contiguous
   layout (its note asserted, the runner a contiguous ``ModelRunner``):
   mesh_tp_contig ("2", contiguous: A and D per tp rank), mesh_dp ("2x1":
   D per dp rank each step), mesh_pp ("1x2x1x1x1": A on each stage's 11
   layers a prefill, D on each stage's 11 layers per microbatch; one
   megastep flight whose CUDA graph replay must equal eager), mesh_sp
   ("1x2x1x1": ring prefill and the sp decode in plain torch, no A or D
   launch; its logits also against one device), mesh_pp_tp ("1x2x1x1x2",
   four ranks).  Then mesh_ep: mixtral-8x7b in bf16 at full width cut to
   2 of 32 layers, paged, "1x2x1": G per ep bank, 2 streams, beside the
   same model on one device.  Each line: launches against the
   expectation, one decode step's logits through the kernels against
   their plain versions (``LOGIT_RTOL_TP``), every stream done, the share
   of greedy tokens equal to the one-device engine's, the steady decode
   step (CUDA events) and TTFT beside the one-device engine's, the peak
   memory and its ratio to the one-device run, and the card's name and
   power limit.  mesh_dp, mesh_pp, mesh_sp and mesh_ep also keep their
   prefill logits of one prompt for the multiprocess lines.

17. multiprocess_* (a leader and a follower line each): one worker over
   two processes on the one card (``parallel/multihost.py``, gloo: the
   processes share the card), every mesh served in one launch of the two
   processes (``mp_child``).  TinyLlama cut to MESH_LAYERS on "1x2" paged
   (tp across the processes; beside the one-process engine on the same
   mesh, run here), "2x1" contiguous (dp), "1x2x1x1x1" (a pp stage a
   process), "1x2x1x1" (an sp shard a process) and "2x1" with n-gram
   speculation (a dp rank a process), and mixtral-8x7b bf16 cut to
   MESH_EP_LAYERS on "1x2x1" (an expert bank a process), beside mesh_dp
   (dp and speculation), mesh_pp, mesh_sp and mesh_ep.
   Each line: every stream done, the repeat equal, each process's
   launches and each launched kernel (A, B/F, D, G) against its plain
   version on the served inputs, the prefill logits against the
   one-process mesh's (``LOGIT_RTOL_TP``), the greedy share, the leader's
   steady step with the frames' host us and the collectives' ms, TTFT,
   memory per process and the collective backend.

Each engine phase starts once the previous engine has stopped and its
memory is freed; its peak memory is counted from before the engine loads
its weights (TinyLlama's kept on the host between phases, llama-3-8b's
made on the card for each phase), the start's peak and the serving peak
apart.  No engine path of either package runs kernel E (the
unified ragged step replaced it), so it launches only in the kernel
phase and its row's launch count is 0; the fp32 entries of A and D run
on the distill phases' paths at Dh 64 and 256, so their Dh-128 rows'
counts are 0.  Tinyllama's seed-0 weights are made once and kept on the
host; no phase changes them (the gateway phase zeroes the unembedding columns
of a copy on the card).
Every line carries ``t_s``, the seconds since the script started.
Then the ``kernels`` line (a row per kernel and head dim, the Dh-128
rows named ``<symbol>_dh128`` with the llama phases' launches, the
Dh-256 rows ``<symbol>_dh256`` with the Gemma-2-9b phases', the Dh-80
rows ``<symbol>_dh80`` with the Danube phases' and the Dh-96 rows
``<symbol>_dh96`` at 0 (no served model has that head dim); kernel
G's three entries with their ``moe`` phases' launches and the 8-slot
Mixtral decode shape's times), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: non-zero exit and
no last line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import dataclasses
import functools
import gc
import itertools
import json
import struct
import subprocess
import sys
import time

import torch

# H100 SXM dense bf16 (data sheet, 700 W).  Also the operations bound of
# the int8-pool kernels: their products pair a bf16 query with int8 keys
# and values, which convert to bf16 exactly, so bf16 is their rate.
PEAK_BF16_FLOPS = 989e12
# H100 SXM fp32 outside the tensor cores (data sheet, 700 W): the bound of
# kernel D's fp32 entry, whose products are fp32 FMAs (kernel A's fp32
# entry runs 3xTF32 on the tensor cores: this rate is its second bound,
# bound_fp32_fma_ms).
PEAK_FP32_FLOPS = 67e12
# H100 SXM dense TF32 on the tensor cores (data sheet, 700 W).  Kernel A's
# fp32 entry takes three TF32 products a product (3xTF32), so a third of
# it is that entry's rate on the tensor cores and its bound.
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# At most the H100's boost clock (1.98 GHz): a sleep of this many cycles
# per second of host time lasts at least that long.
SLEEP_CYCLES_PER_S = 2e9
# Kernel vs plain on one output element: both read the same bf16 inputs and
# accumulate in fp32 in different orders, then round to bf16, so they may
# differ by one bf16 ulp of the value (2^-8 relative) plus fp32 order noise.
ATOL, RTOL = 2e-2, 1e-2
# The fp32 entries of A and D against the plain versions on fp32 inputs:
# no rounding to bf16 anywhere, only fp32 summation order (about 1e-6 of
# outputs of order 1), so ten times that.
ATOL_FP32, RTOL_FP32 = 1e-5, 1e-5
# One step's logits through the kernels vs through the plain versions:
# each of the 22 layers' attention outputs may differ by one bf16 rounding
# (above), and random-weight layers carry that noise to the logits, so the
# bound is relative to the logits' own scale: 5% of max |logit|.
LOGIT_RTOL = 0.05
# The tensor-parallel phases: 2% of max |logit| (the sharded step differs
# from the one-device one only by the order of the row-parallel sums).
LOGIT_RTOL_TP = 0.02
# tp=2 on one card holds the same weights and pools as tp=1.
TP_MEMORY_RATIO = 1.1


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """Print one phase line, with the seconds since the script started
    (``t_s``: what each phase adds to the run's time)."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - _T0}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``: ``iters`` calls between two CUDA
    events, queued behind a device sleep twice as long as the host took to
    issue them, so the events time the device's work back to back and not
    the host's gaps between launches (which set the time of a call that is
    faster than its own launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# The SDPA backends tried on a call (flash and cuDNN refuse fp32); the
# math backend only when none of these takes the call.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_ms(fn) -> tuple[float, str]:
    """Device ms of the SDPA call ``fn`` under the fastest backend of
    SDPA_BACKENDS that runs it (flash takes no arbitrary mask nor fp32;
    some take no head dim of 256), else under the math backend, and that
    backend."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in SDPA_BACKENDS + ("MATH",):
        if name == "MATH" and times:
            break
        with sdpa_kernel(getattr(SDPBackend, name)), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            times[name.lower()] = time_ms(fn)
    if not times:
        raise AssertionError("no SDPA backend runs the call")
    best = min(times, key=times.get)
    return times[best], best


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rows=None, atol: float = ATOL, rtol: float = RTOL) -> float:
    """Max |got - want| over ``rows`` (all when None); raises beyond
    atol + rtol * |want|."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"tolerance, max abs err {float(err.max()):.4g}")
    return float(err.max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------ kernel phase

def check_prefill(dev, gen, t: int, softcap: float, window: int,
                  masked_rows: int, timed: bool, h: int = 32, hkv: int = 4,
                  dh: int = 64, dtype: torch.dtype = torch.bfloat16,
                  b: int = 1) -> dict:
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import flash_prefill_attention

    f32 = dtype == torch.float32
    bf = dict(device=dev, dtype=dtype)
    q = torch.randn((b, t, h, dh), generator=gen, **bf)
    k = torch.randn((b, hkv, t, dh), generator=gen, **bf)
    v = torch.randn((b, hkv, t, dh), generator=gen, **bf)
    pos = torch.arange(t, device=dev, dtype=torch.int32)[None].expand(
        b, t).contiguous()
    valid = torch.ones((b, t), device=dev, dtype=torch.bool)
    valid[:, :masked_rows] = False  # queries < masked_rows see no key
    scale = dh ** -0.5
    args = (q, k, v, pos, scale)
    kw = dict(softcap=softcap, sliding_window=window, kv_valid=valid)
    got = flash_prefill_attention(*args, **kw)
    want = prefill_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    if masked_rows and got[:, :masked_rows].abs().max() != 0:
        raise AssertionError("prefill: all-masked rows must be zero")
    if got.dtype != dtype:
        raise AssertionError(f"prefill: {dtype} in, {got.dtype} out")
    tol = dict(atol=ATOL_FP32, rtol=RTOL_FP32) if f32 else {}
    err = compare(f"prefill b={b} t={t} {dtype}", got[:, masked_rows:],
                  want[:, masked_rows:], **tol)
    res = {"max_abs_err": err}
    if timed:
        g = h // hkv
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        qt = q.transpose(1, 2)
        res["ms"] = time_ms(lambda: flash_prefill_attention(*args, **kw))
        res["plain_ms"] = time_ms(lambda: prefill_attention_ref(*args, **kw))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kr, vr, is_causal=True, scale=scale)

        res["library_ms"], res["library_backend"] = sdpa_ms(sdpa)
        seen = t * (t + 1) // 2  # causal (query, key) pairs per head
        # fp32 at fp32 accuracy: the card's fastest route is 3xTF32 on the
        # tensor cores (a third of the TF32 rate); the fp32-FMA rate's
        # bound is kept beside it.
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, k, v, pos, valid, got), 4 * dh * h * b * seen,
            PEAK_TF32_FLOPS / 3 if f32 else PEAK_BF16_FLOPS)
        if f32:
            res["bound_fp32_fma_ms"] = bound_ms(
                nbytes(q, k, v, pos, valid, got), 4 * dh * h * b * seen,
                PEAK_FP32_FLOPS)[0]
    return res


def _paged_inputs(dev, gen, b: int, lens: list[int], page: int, np_: int,
                  pool_pages: int, hkv: int = 4, dh: int = 64):
    """A pool with distinct random pages per slot: table row i holds slot
    i's pages (the dump page, pool_pages - 1, pads every row)."""
    bf = dict(device=dev, dtype=torch.bfloat16)
    pool_k = torch.randn((pool_pages, hkv, page, dh), generator=gen, **bf)
    pool_v = torch.randn((pool_pages, hkv, page, dh), generator=gen, **bf)
    perm = torch.randperm(pool_pages - 1, generator=torch.Generator(
        ).manual_seed(b))
    table = torch.full((b, np_), pool_pages - 1, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // page)
        table[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    return pool_k, pool_v, table.to(dev)


def _sdpa_gathered(q, pool_k, pool_v, table, lens, qpos):
    """One SDPA call over each row's gathered pages (gather and head
    repeat done here, outside the timed call); q [R, H, Q, Dh]."""
    r, h = q.shape[0], q.shape[1]
    _, hkv, page, dh = pool_k.shape
    w = table.shape[1] * page
    kk = pool_k[table.long()].permute(0, 2, 1, 3, 4).reshape(r, hkv, w, dh)
    vv = pool_v[table.long()].permute(0, 2, 1, 3, 4).reshape(r, hkv, w, dh)
    kk = kk.repeat_interleave(h // hkv, 1)
    vv = vv.repeat_interleave(h // hkv, 1)
    kpos = torch.arange(w, device=q.device)
    mask = ((kpos[None, None] < lens[:, None, None])
            & (kpos[None, None] <= qpos[:, :, None]))[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, attn_mask=mask)


def _quantized(pool_k, pool_v):
    """int8 pools with their bf16 scales (``quantize_kv`` of bf16 K/V), and
    the pools dequantized to bf16 for the library call's yardstick."""
    from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    (pk8, ks), (pv8, vs) = quantize_kv(pool_k), quantize_kv(pool_v)
    deq = (dequantize_kv(pk8, ks).to(torch.bfloat16),
           dequantize_kv(pv8, vs).to(torch.bfloat16))
    return pk8, pv8, dict(k_scale=ks, v_scale=vs), deq


def _kv_token_bytes(hkv: int, dh: int, int8: bool) -> int:
    """Bytes of one live token's K and V (and their bf16 scales)."""
    return hkv * dh * 2 * (1 if int8 else 2) + (hkv * 2 * 2 if int8 else 0)


def check_decode(dev, gen, lens: list[int], softcap: float, window: int,
                 timed: bool, int8: bool = False, hkv: int = 4,
                 dh: int = 64, h: int = 32) -> dict:
    """Kernel B (bf16 pool, or the int8 variant on a quantized pool)
    against its plain version."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        paged_decode_attention_plain,
    )

    b, page, np_ = len(lens), 128, 16
    pool_k, pool_v, table = _paged_inputs(dev, gen, b, lens, page, np_, 129,
                                          hkv, dh)
    lib_pools, scales = (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((b, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    seq = torch.tensor(lens, device=dev, dtype=torch.int32)
    args = (q, pool_k, pool_v, table, seq, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window, **scales)
    got = flash_paged_decode_attention(*args, **kw)
    again = flash_paged_decode_attention(*args, **kw)
    want = paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("decode: two calls differ (the split merge must "
                             "read its partials in split order)")
    live = [i for i, n in enumerate(lens) if n > 0]
    dead = [i for i, n in enumerate(lens) if n == 0]
    if dead and got[dead].abs().max() != 0:
        raise AssertionError("decode: a zero-length slot must output zeros")
    res = {"max_abs_err": compare("decode", got, want, live)}
    if timed:
        res["ms"] = time_ms(lambda: flash_paged_decode_attention(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: paged_decode_attention_plain(*args, **kw))
        res["library_ms"], res["library_backend"] = sdpa_ms(_sdpa_gathered(
            q[:, :, None], *lib_pools, table, seq, (seq - 1)[:, None]))
        kv = sum(lens) * _kv_token_bytes(hkv, dh, int8)  # live tokens only
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, table, seq, got) + kv, 4 * dh * h * sum(lens))
    return res


def check_ragged(dev, gen, dec_lens: list[int], chunk_slot: int, ctx: int,
                 c: int, valid: int, softcap: float, window: int,
                 timed: bool, int8: bool = False, hkv: int = 4,
                 dh: int = 64, h: int = 32) -> dict:
    """Kernel C (bf16 pool, or the int8 variant) against its plain version.
    The kernel reads the chunk's KV back from the pool, so on an int8 pool
    the plain version is fed the chunk rows as the pool holds them
    (dequantized in fp32); the gap to the plain version fed the fresh
    bf16 rows (what the engine's CPU path does) is reported apart."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        ragged_paged_attention,
        ragged_paged_attention_ref,
    )
    from crowdllama_tpu_torch.ops.quant import dequantize_kv

    b, page, np_ = len(dec_lens), 128, 16
    lens = list(dec_lens)
    lens[chunk_slot] = ctx + valid  # the chunk slot's pages hold ctx+chunk
    pool_k, pool_v, table = _paged_inputs(dev, gen, b, lens, page, np_, 129,
                                          hkv, dh)
    fresh_pools, lib_pools, scales = (pool_k, pool_v), (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((b + c, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    q_lens = [1 if n > 0 else 0 for n in dec_lens] + [valid]
    q_lens[chunk_slot] = 0  # the reserved slot does not decode
    kv_lens = [max(n, 1) for n in dec_lens] + [ctx + valid]
    # The chunk's fresh KV, carved back out of the pool where the engine
    # has already written it (the plain version reads it as operands).
    cpos = (ctx + torch.arange(c, device=dev)).clamp(max=ctx + valid - 1)
    cpages = table[chunk_slot, (cpos // page).long()].long()
    co = cpos % page

    def rows(pool, sc=None):
        x = pool[cpages, :, co]
        if sc is not None:
            x = dequantize_kv(x, sc[cpages, :, co])
        return x.transpose(0, 1)[None].contiguous()

    chunk_k = rows(pool_k, scales.get("k_scale"))
    chunk_v = rows(pool_v, scales.get("v_scale"))
    ql = torch.tensor(q_lens, device=dev, dtype=torch.int32)
    kl = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    tail = (pool_k, pool_v, table, ql, kl, chunk_slot, dh ** -0.5)
    args = (q, chunk_k, chunk_v, *tail)
    kw = dict(softcap=softcap, sliding_window=window, **scales)
    got = ragged_paged_attention(*args, **kw)
    want = ragged_paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    live = [i for i in range(b) if q_lens[i]] + [b + i for i in range(valid)]
    dead = [i for i in range(b) if not q_lens[i]] + [
        b + i for i in range(valid, c)]
    if dead and got[dead].abs().max() != 0:
        raise AssertionError("ragged: rows without a query must be zeros")
    res = {"max_abs_err": compare("ragged", got, want, live)}
    if int8:
        fresh = ragged_paged_attention_ref(
            q, rows(fresh_pools[0]), rows(fresh_pools[1]), *tail, **kw)
        res["fresh_kv_gap"] = float((got[live].float()
                                     - fresh[live].float()).abs().max())
    if timed:
        res["ms"] = time_ms(lambda: ragged_paged_attention(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: ragged_paged_attention_ref(*args, **kw))
        # One padded SDPA call: row b..b+? -> [B+1, H, C, Dh] queries.
        qq = torch.zeros((b + 1, h, c, dh), device=dev, dtype=torch.bfloat16)
        qq[:b, :, 0] = q[:b]
        qq[b] = q[b:].transpose(0, 1)
        tab = torch.cat([table, table[chunk_slot][None]])
        qpos = torch.zeros((b + 1, c), device=dev, dtype=torch.int64)
        qpos[:b, 0] = kl[:b] - 1
        qpos[b] = cpos
        res["library_ms"], res["library_backend"] = sdpa_ms(_sdpa_gathered(
            qq, *lib_pools, tab, kl, qpos))
        dec = [kv_lens[i] for i in range(b) if q_lens[i]]
        seen = sum(dec) + sum(ctx + r + 1 for r in range(valid))
        kv_tokens = sum(dec) + ctx + valid
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, ql, kl, table, got)
            + kv_tokens * _kv_token_bytes(hkv, dh, int8), 4 * dh * h * seen)
    return res


def check_flash_decode(dev, gen, lens: list[int], s: int, softcap: float,
                       window: int, timed: bool, hkv: int = 4,
                       dh: int = 64, dtype: torch.dtype = torch.bfloat16,
                       h: int = 32) -> dict:
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    f32 = dtype == torch.float32
    b = len(lens)
    bf = dict(device=dev, dtype=dtype)
    q = torch.randn((b, h, dh), generator=gen, **bf)
    kc = torch.randn((b, hkv, s, dh), generator=gen, **bf)
    vc = torch.randn((b, hkv, s, dh), generator=gen, **bf)
    seq = torch.tensor(lens, device=dev, dtype=torch.int32)
    args = (q, kc, vc, seq, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_decode_attention(*args, **kw)
    again = flash_decode_attention(*args, **kw)
    want = decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("flash decode: two calls differ (the split "
                             "merge must read its partials in split order)")
    live = [i for i, n in enumerate(lens) if n > 0]
    dead = [i for i, n in enumerate(lens) if n == 0]
    if dead and got[dead].abs().max() != 0:
        raise AssertionError("flash decode: a zero-length slot must output "
                             "zeros")
    if got.dtype != dtype:
        raise AssertionError(f"flash decode: {dtype} in, {got.dtype} out")
    tol = dict(atol=ATOL_FP32, rtol=RTOL_FP32) if f32 else {}
    res = {"max_abs_err": compare(f"flash decode {dtype}", got, want, live,
                                  **tol)}
    if timed:
        res["ms"] = time_ms(lambda: flash_decode_attention(*args, **kw))
        res["plain_ms"] = time_ms(lambda: decode_attention_plain(*args, **kw))
        # One SDPA call over the same cache, heads repeated and the length
        # mask built beforehand (outside the timing).
        kr, vr = kc.repeat_interleave(h // hkv, 1), vc.repeat_interleave(
            h // hkv, 1)
        mask = (torch.arange(s, device=dev)[None] < seq[:, None])[:, None,
                                                                   None]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kr, vr, attn_mask=mask)

        res["library_ms"], res["library_backend"] = sdpa_ms(sdpa)
        # live K and V rows
        kv = sum(lens) * hkv * dh * 2 * kc.element_size()
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, seq, got) + kv, 4 * dh * h * sum(lens),
            PEAK_FP32_FLOPS if f32 else PEAK_BF16_FLOPS)
    return res


def check_chunk(dev, gen, ctx: int, c: int, valid: int, softcap: float,
                window: int, timed: bool, int8: bool = False,
                h: int = 32, hkv: int = 4, dh: int = 64) -> dict:
    """Kernel E (bf16 pool, or the int8 variant) against its plain version:
    a chunk of ``c`` rows (``valid`` carry a query) at context ``ctx`` over
    its slot's pages, which hold ctx + valid tokens; ``h`` query heads over
    ``hkv`` kv heads."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_ragged_chunk_attention,
        ragged_chunk_attention_plain,
    )

    page, np_ = 128, 16
    pool_k, pool_v, table = _paged_inputs(dev, gen, 1, [ctx + valid], page,
                                          np_, 129, hkv, dh)
    lib_pools, scales = (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((c, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    i32 = dict(device=dev, dtype=torch.int32)
    ctx_t, kv_t = torch.tensor(ctx, **i32), torch.tensor(ctx + valid, **i32)
    args = (q, pool_k, pool_v, table[0], ctx_t, kv_t, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window, **scales)
    got = flash_ragged_chunk_attention(*args, **kw)
    want = ragged_chunk_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    if valid < c and got[valid:].abs().max() != 0:
        raise AssertionError("chunk: rows past the valid ones must be zeros")
    res = {"max_abs_err": compare(f"chunk ctx={ctx}", got[:valid],
                                  want[:valid])}
    if timed:
        res["ms"] = time_ms(lambda: flash_ragged_chunk_attention(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: ragged_chunk_attention_plain(*args, **kw))
        qpos = (ctx + torch.arange(c, device=dev))[None]
        res["library_ms"], res["library_backend"] = sdpa_ms(_sdpa_gathered(
            q.transpose(0, 1)[None], *lib_pools, table, kv_t[None], qpos))
        seen = sum(ctx + r + 1 for r in range(valid))
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, table[0], ctx_t, kv_t, got)
            + (ctx + valid) * _kv_token_bytes(hkv, dh, int8),
            4 * dh * h * seen)
    return res


def check_tp_decode(dev, gen, lens: list[int], tp: int, softcap: float,
                    window: int, timed: bool, int8: bool = False,
                    hkv: int = 4, dh: int = 64, h: int = 32) -> dict:
    """Kernel F on tp shares of B's inputs (q heads and pool kv heads,
    kv-major): every rank's output must equal B's on the whole pool bit
    for bit, and F is held against its plain version."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        flash_paged_decode_attention_tp,
        paged_decode_attention_tp_plain,
    )

    b, page, np_ = len(lens), 128, 16
    pool_k, pool_v, table = _paged_inputs(dev, gen, b, lens, page, np_, 129,
                                          hkv, dh)
    lib_pools, scales = (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((b, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    seq = torch.tensor(lens, device=dev, dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    whole = flash_paged_decode_attention(q, pool_k, pool_v, table, seq,
                                         dh ** -0.5, **kw, **scales)

    def cut(x):
        return [part.contiguous() for part in x.chunk(tp, dim=1)]

    args = (cut(q), cut(pool_k), cut(pool_v), table, seq, dh ** -0.5)
    kw.update({f"{k}s": cut(v) for k, v in scales.items()})
    before = _launches()
    got = torch.cat(flash_paged_decode_attention_tp(*args, **kw), dim=1)
    moved = {k: n - before[k] for k, n in _launches().items()
             if n != before[k]}
    if moved != {"F_int8" if int8 else "F": 1}:
        raise AssertionError(f"tp decode (tp={tp}) on one card must be one "
                             f"F launch and nothing else: {moved}")
    want = torch.cat(paged_decode_attention_tp_plain(*args, **kw), dim=1)
    torch.cuda.synchronize()
    if not torch.equal(got, whole):
        raise AssertionError(f"tp decode (tp={tp}) differs from kernel B on "
                             f"the whole pool")
    live = [i for i, n in enumerate(lens) if n > 0]
    res = {"max_abs_err": compare(f"tp decode tp={tp}", got, want, live),
           "equal_to_B": True}
    if timed:
        res["ms"] = time_ms(
            lambda: flash_paged_decode_attention_tp(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: paged_decode_attention_tp_plain(*args, **kw))
        res["library_ms"], res["library_backend"] = sdpa_ms(_sdpa_gathered(
            q[:, :, None], *lib_pools, table, seq, (seq - 1)[:, None]))
        kv = sum(lens) * _kv_token_bytes(hkv, dh, int8)  # live tokens only
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, table, seq, got) + kv, 4 * dh * h * sum(lens))
    return res


# Lengths on the edges of the split plan of kernels B and D at the serving
# table (16 pages of 128: splits of 2 pages, 256 keys) and cache (2,048
# keys, splits of 256): an empty slot, one key, a page less one, a page, a
# page and one, one split, one split and one key, the whole table.  Cases (softcap, window): none; a window of 40 (the
# 2,048-token slot's keys in its last split only, 7 splits empty); softcap
# and a window of 300 (first key 1,748: 6 splits empty, 2 merged).
SPLIT_EDGE_LENS = [0, 1, 127, 128, 129, 256, 257, 2048]
SPLIT_EDGE_CASES = [(0.0, 0), (0.0, 40), (30.0, 300)]
# The 8 decode slots' lengths of the timed decode shapes (6,924 live keys).
SERVE_LENS = [1723, 1, 402, 2048, 77, 1200, 513, 960]


def fp32_checks(dev, gen, f32: dict) -> dict:
    """The fp32 entries of A and D against their plain versions on fp32
    inputs (``f32``: kernel_checks' heads and head dim, fp32): the serving
    shapes timed, the small shapes, the distill phase's shapes."""
    a32 = check_prefill(dev, gen, 512, 0.0, 0, 0, timed=True, **f32)
    a32["small"] = [check_prefill(dev, gen, 64, 30.0, 9, 5, False, **f32)
                    ["max_abs_err"],
                    check_prefill(dev, gen, 96, 0.0, 17, 0, False, **f32)
                    ["max_abs_err"],
                    check_prefill(dev, gen, 200, 0.0, 0, 0, False,
                                  **dict(f32, h=7 * f32["hkv"]))
                    ["max_abs_err"]]
    # The distill phase's shapes: the train step's 16 x 64-token batch
    # (teacher and student), the rollout's 64 slots over a 64-key cache at
    # every length it steps through.
    seq, slots = int(DISTILL["--seq-len"]), int(DISTILL["--corpus-seqs"])
    a32["distill_shape"] = check_prefill(
        dev, gen, seq, 0.0, 0, 0, False, b=int(DISTILL["--batch"]),
        **f32)["max_abs_err"]
    d32 = check_flash_decode(dev, gen, SERVE_LENS, 2048, 0.0, 0, timed=True,
                             **f32)
    d32["small"] = [check_flash_decode(dev, gen, [0, 5, 300, 129], 300,
                                       30.0, 0, False, **f32)["max_abs_err"],
                    check_flash_decode(dev, gen, [260, 1, 0, 64], 300, 0.0,
                                       40, False, **f32)["max_abs_err"]]
    d32["split_edges"] = [
        check_flash_decode(dev, gen, SPLIT_EDGE_LENS, 2048, sc, win, False,
                           **f32)["max_abs_err"]
        for sc, win in SPLIT_EDGE_CASES]
    d32["distill_shape"] = check_flash_decode(
        dev, gen, [1 + i % seq for i in range(slots)], seq, 0.0, 0, False,
        **f32)["max_abs_err"]
    return {"A_fp32": a32, "D_fp32": d32}


def kernel_checks(dev, gen, hkv: int, dh: int, h: int = 32) -> dict:
    """Every kernel against its plain version at head dim ``dh`` over
    ``h`` query and ``hkv`` kv heads (TinyLlama's 32 / 4 at Dh 64,
    Llama-3-8B's 32 / 8 at Dh 128, Gemma-2-9b's 16 / 8 at Dh 256,
    H2O-Danube-1.8B's 32 / 8 at Dh 80 and the same heads at Dh 96): the
    serving shapes timed, then the small shapes; the fp32 entries of A
    and D on the same heads (``fp32_checks``) where they are compiled
    (``FP32_HEAD_DIMS``)."""
    d = dict(hkv=hkv, dh=dh, h=h)
    out = {}
    a = check_prefill(dev, gen, 512, 0.0, 0, 0, timed=True, **d)
    a["small"] = [check_prefill(dev, gen, 64, 30.0, 9, 5, False, **d)
                  ["max_abs_err"],
                  check_prefill(dev, gen, 96, 0.0, 17, 0, False, **d)
                  ["max_abs_err"]]
    out["A"] = a
    serve_lens = SERVE_LENS
    for key, int8 in (("B", False), ("B_int8", True)):
        bres = check_decode(dev, gen, serve_lens, 0.0, 0, timed=True,
                            int8=int8, **d)
        bres["small"] = [
            check_decode(dev, gen, [0, 5, 300, 129], 30.0, 0, False,
                         int8=int8, **d)["max_abs_err"],
            check_decode(dev, gen, [260, 1, 0, 64], 0.0, 40, False,
                         int8=int8, **d)["max_abs_err"]]
        bres["split_edges"] = [
            check_decode(dev, gen, SPLIT_EDGE_LENS, sc, win, False,
                         int8=int8, **d)["max_abs_err"]
            for sc, win in SPLIT_EDGE_CASES]
        out[key] = bres
    ragged_serve = ([1723, 1, 402, 0, 77, 1200, 0, 960], 3, 1024, 512, 512,
                    0.0, 0)
    ragged_small = [([40, 0, 300, 0], 3, 256, 96, 70, 30.0, 0),
                    ([40, 130, 0, 9], 2, 128, 64, 64, 0.0, 33),
                    ([40, 0, 300, 0], 3, 200, 75, 61, 30.0, 100)]
    for key, int8 in (("C", False), ("C_int8", True)):
        cres = check_ragged(dev, gen, *ragged_serve, timed=True, int8=int8,
                            **d)
        small = [check_ragged(dev, gen, *a, timed=False, int8=int8, **d)
                 for a in ragged_small]
        cres["small"] = [r["max_abs_err"] for r in small]
        if int8:
            cres["small_fresh_kv_gap"] = [r["fresh_kv_gap"] for r in small]
        out[key] = cres
    if dh == 64:
        # The chunks the autopilot's budget and prefill-chunk dials give
        # (the prefill chunk clamped to budget - slots, floored to the
        # 128-token page): a whole chunk and LONG's last one at each.
        from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer

        n = len(ByteTokenizer().encode(LONG))
        out["C"]["chunk_rows"] = {
            str(c): [check_ragged(dev, gen, ragged_serve[0], 3, ctx, c, v,
                                  0.0, 0, timed=False, **d)["max_abs_err"]
                     for ctx, v in ((0, c), (n - 1 - (n - 1) % c,
                                             (n - 1) % c + 1))]
            for c in (128, 256, 384, 1024)}
    # The longest prompt a prefill chunk of 1024 admits in one prefill.
    out["A"]["q1024"] = check_prefill(dev, gen, 1024, 0.0, 0, 0, False,
                                      **d)["max_abs_err"]
    dres = check_flash_decode(dev, gen, serve_lens, 2048, 0.0, 0, timed=True,
                              **d)
    dres["small"] = [check_flash_decode(dev, gen, [0, 5, 300, 129], 300,
                                        30.0, 0, False, **d)["max_abs_err"],
                     check_flash_decode(dev, gen, [260, 1, 0, 64], 300, 0.0,
                                        40, False, **d)["max_abs_err"]]
    dres["split_edges"] = [
        check_flash_decode(dev, gen, SPLIT_EDGE_LENS, 2048, sc, win, False,
                           **d)["max_abs_err"]
        for sc, win in SPLIT_EDGE_CASES]
    out["D"] = dres
    # The fp32 entries (the distillation trainer's teacher and student).
    from crowdllama_tpu_torch.ops.cuda import FP32_HEAD_DIMS

    if dh in FP32_HEAD_DIMS:
        out.update(fp32_checks(dev, gen, dict(d, dtype=torch.float32)))
    for key, int8 in (("E", False), ("E_int8", True)):
        eres = check_chunk(dev, gen, 1024, 512, 512, 0.0, 0, timed=True,
                           int8=int8, **d)
        eres["small"] = [
            check_chunk(dev, gen, 256, 96, 70, 30.0, 0, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 128, 80, 77, 0.0, 33, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 0, 64, 64, 0.0, 0, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 200, 75, 60, 30.0, 100, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 200, 75, 61, 0.0, 100, False, int8=int8,
                        **dict(d, h=7 * hkv))["max_abs_err"]]
        out[key] = eres
    for key, int8 in (("F", False), ("F_int8", True)):
        fres = check_tp_decode(dev, gen, serve_lens, 2, 0.0, 0, timed=True,
                               int8=int8, **d)
        fres["tp4"] = check_tp_decode(dev, gen, serve_lens, 4, 0.0, 0,
                                      False, int8=int8, **d)["max_abs_err"]
        fres["small"] = [
            check_tp_decode(dev, gen, [0, 5, 300, 129], 2, 30.0, 0, False,
                            int8=int8, **d)["max_abs_err"],
            check_tp_decode(dev, gen, [260, 1, 0, 64], 4, 0.0, 40, False,
                            int8=int8, **d)["max_abs_err"]]
        fres["split_edges"] = [
            check_tp_decode(dev, gen, SPLIT_EDGE_LENS, tp, sc, win, False,
                            int8=int8, **d)["max_abs_err"]
            for tp, (sc, win) in zip((2, 4, 2), SPLIT_EDGE_CASES)]
        out[key] = fres
    return out


# (head dim, query heads, kv heads) of each kernel line: TinyLlama,
# Llama-3-8B, Gemma-2-9b, H2O-Danube-1.8B (Dh 80) and its heads at Dh 96;
# a row's key takes the suffix of its head dim.
KERNEL_LINES = ((64, 32, 4), (128, 32, 8), (256, 16, 8), (80, 32, 8),
                (96, 32, 8))
DH_SUFFIX = {64: "", 128: "_dh128", 256: "_dh256", 80: "_dh80", 96: "_dh96"}
# The rows of the fp32 entries, which run only at FP32_HEAD_DIMS.
FP32_ROWS = ("A_fp32", "D_fp32")


def kernel_line(dev, gen, dh: int, h: int, hkv: int) -> dict:
    """One ``kernels_vs_plain`` line: every kernel against its plain
    version at head dim ``dh`` over ``h`` / ``hkv`` heads (timed, bound,
    one SDPA call naming its backend); returns the rows keyed by kernel
    and the head dim's suffix."""
    t0 = time.perf_counter()
    res = kernel_checks(dev, gen, hkv, dh, h)
    emit({"phase": "kernels_vs_plain", "head_dim": dh, "heads": h,
          "kv_heads": hkv, "tolerance": {"atol": ATOL, "rtol": RTOL},
          "tolerance_fp32": {"atol": ATOL_FP32, "rtol": RTOL_FP32},
          "seconds": time.perf_counter() - t0, **res})
    return {k + DH_SUFFIX[dh]: v for k, v in res.items()}


def kernel_phase(dev) -> dict:
    """The kernel checks at Dh 64 (TinyLlama), Dh 128 (Llama-3-8B), Dh
    256 (Gemma-2-9b's 16 query / 8 kv heads), Dh 80 (H2O-Danube-1.8B's 32
    / 8) and Dh 96 (the same heads), a line each, then kernel A at a group
    of 7 (qwen2.5-7b's 28 query / 4 kv heads: 18 queries a block, its last
    two rows empty) at all five; returns the rows keyed by kernel and head
    dim (``DH_SUFFIX``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dh, h, hkv in KERNEL_LINES:
        out.update(kernel_line(dev, gen, dh, h, hkv))
    group7 = {dh: [check_prefill(dev, gen, 512, 0.0, 0, 0, False, h=28,
                                 dh=dh)["max_abs_err"],
                   check_prefill(dev, gen, 96, 30.0, 17, 5, False, h=28,
                                 dh=dh)["max_abs_err"]]
              for dh, _, _ in KERNEL_LINES}
    emit({"phase": "kernel_A_group7", "heads": [28, 4],
          "max_abs_err": group7})
    return out


# ------------------------------------------------------------ engine phases

TINYLLAMA = "tinyllama-1.1b"
LLAMA = "llama-3-8b"
# Depth of the llama-3-8b phases beside the full-depth paged one.
LLAMA_CUT_LAYERS = 4

SHORT = [
    "The swarm routes each request to a worker that holds the model. " * 6,
    "Paged attention keeps the KV cache in fixed pages shared by slots. " * 4,
    "Hopper kernels read pages straight from the pool through the table.",
    "A continuous batch admits new requests while others are decoding. " * 3,
    "Prefix caching reuses the pages of a prompt that was served before. " * 5,
    "Greedy decoding takes the argmax of the logits at every step. " * 2,
]
HIT = SHORT[0][:300] + " and a different tail that only this request sends."
LONG = ("Long prompts are prefilled in chunks inside the decode dispatch, "
        "so the other streams keep emitting tokens while it runs. ") * 12
SAMPLED = ("A seeded sampled stream draws its tokens from threefry keys.",
           dict(temperature=0.8, seed=1234))
GREEDY = {f"short{i}": (p, {}) for i, p in enumerate(SHORT)}

# The token ids a stream received, per asyncio task (see _IdRecorder).
_STREAM_IDS: contextvars.ContextVar = contextvars.ContextVar("stream_ids",
                                                             default=None)


class _IdRecorder:
    """Tokenizer proxy: each stream's decoder appends the token ids it is
    fed to the list its task set in ``_STREAM_IDS``."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), _STREAM_IDS.get()

        class _Dec:
            def feed(self, token_id):
                if ids is not None:
                    ids.append(int(token_id))
                return dec.feed(token_id)

        return _Dec()


def _counters() -> dict:
    """Kernel row -> (wrapper, its launch-count attribute)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        flash_decode_attention,
        flash_prefill_attention,
    )
    from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        flash_paged_decode_attention_tp,
        flash_ragged_chunk_attention,
        ragged_paged_attention,
    )

    return {"A": (flash_prefill_attention, "launches"),
            "A_fp32": (flash_prefill_attention, "launches_fp32"),
            "B": (flash_paged_decode_attention, "launches"),
            "B_int8": (flash_paged_decode_attention, "launches_int8"),
            "C": (ragged_paged_attention, "launches"),
            "C_int8": (ragged_paged_attention, "launches_int8"),
            "D": (flash_decode_attention, "launches"),
            "D_fp32": (flash_decode_attention, "launches_fp32"),
            "E": (flash_ragged_chunk_attention, "launches"),
            "E_int8": (flash_ragged_chunk_attention, "launches_int8"),
            "F": (flash_paged_decode_attention_tp, "launches"),
            "F_int8": (flash_paged_decode_attention_tp, "launches_int8"),
            "G": (grouped_gemm, "launches"),
            "G_int8": (grouped_gemm, "launches_int8"),
            "G_int4": (grouped_gemm, "launches_int4")}


def _zero_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _set_launches(counts: dict) -> None:
    for k, (fn, attr) in _counters().items():
        setattr(fn, attr, counts[k])


async def serve(engine, streams: dict, max_tokens: int,
                again: str | None = None, long: bool = True,
                long_prompt: str = LONG) -> dict:
    """Send ``streams`` (name -> (prompt, generate kwargs)) at once, then
    ``long_prompt`` (LONG) once the others are decoding (unless ``long``
    is False), then stream ``again`` alone a second time (as
    ``<again>_again``)."""
    results: dict[str, dict] = {}

    async def run(name: str, prompt: str, kw: dict) -> None:
        ids: list[int] = []
        _STREAM_IDS.set(ids)
        t0 = time.perf_counter()
        final, text = None, ""
        async for chunk in engine.generate(prompt, max_tokens=max_tokens,
                                           **kw):
            final = chunk
            text += chunk.text
        results[name] = {"done": final.done, "reason": final.done_reason,
                         "text": text,
                         "completion_tokens": final.completion_tokens,
                         "prompt_tokens": final.prompt_tokens,
                         "ttft_ms": (final.queue_ns + final.prefill_ns) / 1e6,
                         "wall_s": time.perf_counter() - t0, "ids": ids}

    t0 = time.perf_counter()
    tasks = [asyncio.create_task(run(n, p, kw))
             for n, (p, kw) in streams.items()]
    while (engine.scheduler.tokens_generated < 8
           and not all(t.done() for t in tasks)):
        await asyncio.sleep(0.005)
    if long:
        tasks.append(asyncio.create_task(run("long", long_prompt, {})))
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t0
    if again:
        await run(f"{again}_again", *streams[again])
    return {"requests": results, "wall_s": wall}


def run_engine(dev, streams: dict, max_tokens: int, again: str | None = None,
               params: dict | None = None, random_init: bool = False,
               long_prompt: str = LONG, **engine_kw):
    """Reset the card's peak-memory mark, start ``TorchEngine`` on
    ``params`` (default: TinyLlama's seed-0 weights; with ``random_init``
    the runner's own seed-0 init on the card, quantized as it is drawn
    when ``engine_kw`` sets ``quantize``, its EOS column zeroed) (on
    ``dev``, or on the tp ranks ``devices`` in
    ``engine_kw`` names), zero every launch count, serve the traffic, read
    the counts, stop.  The card's memory is read at four points: what was
    allocated before the engine, the peak while it started (loading and
    warm-up), what stayed allocated after that, and the peak while it
    served; ``max_memory_allocated`` is the larger peak.  The long stream
    sends ``long_prompt``.  Checks that every stream ended done with
    ``max_tokens`` tokens and that a seeded stream sent again repeated
    token for token."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    if "devices" not in engine_kw:
        engine_kw["device"] = dev

    async def go():
        weights = (None if random_init else seed0_params(dev)
                   if params is None else params)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        memory = {"before_start": torch.cuda.memory_allocated(dev)}
        engine = TorchEngine(params=weights, **engine_kw)
        t0 = time.perf_counter()
        await engine.start()
        start_s = time.perf_counter() - t0
        if random_init:
            _zero_eos(engine.runner)
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        try:
            memory.update(start_peak=torch.cuda.max_memory_allocated(dev),
                          after_start=torch.cuda.memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
            hits0 = getattr(engine.runner, "prefix_hits", 0)
            _zero_launches()
            served = await serve(engine, streams, max_tokens, again,
                                 long_prompt=long_prompt)
            launches = _launches()
            memory["serve_peak"] = torch.cuda.max_memory_allocated(dev)
            hits = getattr(engine.runner, "prefix_hits", 0) - hits0
        finally:
            await engine.stop()
        return engine, start_s, served, launches, hits, memory

    engine, start_s, served, launches, hits, memory = asyncio.run(go())
    reqs = served["requests"]
    for name, v in reqs.items():
        if not (v["done"] and v["completion_tokens"] == max_tokens
                and len(v["ids"]) == max_tokens):
            raise AssertionError(
                f"stream {name} ended "
                f"{ {k: x for k, x in v.items() if k not in ('ids', 'text')} }")
    if again and reqs[again]["ids"] != reqs[f"{again}_again"]["ids"]:
        raise AssertionError(f"the seeded stream {again} did not repeat: "
                             f"{reqs[again]['ids']} vs "
                             f"{reqs[again + '_again']['ids']}")
    ttft = sorted(v["ttft_ms"] for k, v in reqs.items()
                  if not k.endswith("_again"))
    tokens = sum(v["completion_tokens"] for k, v in reqs.items()
                 if not k.endswith("_again"))
    summary = {"start_s": start_s, "wall_s": served["wall_s"],
               "completion_tokens": tokens,
               "tokens_per_s": tokens / served["wall_s"],
               "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
               "launches": launches, "prefix_hits": hits,
               "max_memory_allocated": max(memory["start_peak"],
                                           memory["serve_peak"]),
               "memory": memory,
               "requests": {k: {x: y for x, y in v.items()
                                if x not in ("ids", "text")}
                            for k, v in reqs.items()}}
    return engine, summary, reqs


def _expect_launches(launches: dict, ran: set[str], phase: str) -> None:
    """Kernels in ``ran`` launched in the phase's streams; no other did."""
    for k, n in launches.items():
        if (n > 0) != (k in ran):
            raise AssertionError(f"{phase}: kernel {k} launched {n} times "
                                 f"(expected {'> 0' if k in ran else 0}): "
                                 f"{launches}")


def _logit_err(kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    """Max |kernel - plain|, the plain logits' max |logit| and the share of
    rows whose argmax agrees."""
    return {"max_abs_err": float((kernel - plain).abs().max()),
            "scale": float(plain.abs().max()),
            "argmax_agree": float((kernel.argmax(-1) == plain.argmax(-1))
                                  .float().mean())}


def _check_logit_errs(errs: dict, phase: str) -> dict:
    for k, e in errs.items():
        if not e["max_abs_err"] <= LOGIT_RTOL * e["scale"]:
            raise AssertionError(f"{phase} {k} logits: kernel vs plain {e}")
    return errs


def _three_slots(r, tok):
    st = r.init_state()
    for slot, p in enumerate(SHORT[:3]):
        ids = tok.encode(p)
        first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None)
        st = r.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                      prompt_tokens=ids)
    return st


@contextlib.contextmanager
def _swapped(owner, name: str, value):
    """``owner.name`` is ``value`` while entered."""
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


def _plain_products():
    """The model's quantized and expert products through kernel G's plain
    version while entered: a check's reference route."""
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm_plain

    return _swapped(T, "grouped_gemm", grouped_gemm_plain)


class _Routing:
    """MoE routing for a kernel-vs-plain check: the kernel route's expert
    choices, taken by the plain route.  A top-k choice is discontinuous
    (it flips where two router logits nearly tie), so two routes that
    round differently can send a token to other experts and then part by
    far more than their rounding; the plain route here takes the kernel
    route's experts (its own router weights over them) and counts the
    tokens whose own choice would have differed.  Each pair of routes
    runs ``kernel`` then ``plain``; without MoE layers it is a no-op."""

    def __init__(self, moe: bool):
        self.moe = moe
        self.tape: list = []
        self.flips = self.tokens = 0

    def _patched(self, route):
        from crowdllama_tpu_torch.models import transformer as T

        real = T._route_topk
        return _swapped(T, "_route_topk", route(real) if self.moe else real)

    def kernel(self):
        def route(real):
            def recorded(lp, cfg, x):
                w, ids = real(lp, cfg, x)
                self.tape.append(ids)
                return w, ids
            return recorded
        return self._patched(route)

    def plain(self):
        def route(real):
            def replayed(lp, cfg, x):
                ids = self.tape.pop(0)
                logits = x.float() @ lp["router"].float()
                _, own = real(lp, cfg, x)
                self.flips += int((own.sort(-1)[0] != ids.sort(-1)[0])
                                  .any(-1).sum())
                self.tokens += own[..., 0].numel()
                return torch.softmax(logits.gather(-1, ids), dim=-1), ids
            return replayed
        return self._patched(route)

    def report(self, err: dict) -> dict:
        if self.moe:
            err = dict(err, routing_flips=self.flips,
                       routing_tokens=self.tokens)
            self.flips = self.tokens = 0
        return err


def logits_check(engine, dev, ragged: bool = True) -> dict:
    """One decode step through kernel F (B's grid over every rank: its bf16
    or int8 variant, as the runner's pool is) and through its plain version
    on the same state (3 live slots); with ``ragged`` also one prefill through
    kernel A and one ragged step through kernel C, each against its plain
    version.  The kernel route's expert and quantized products go through
    kernel G, the plain route's through G's plain version
    (``T.grouped_gemm`` swapped); on MoE layers the plain route takes the
    kernel route's expert choices (``_Routing``)."""
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import flash_prefill_attention
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        paged_decode_attention_tp_plain,
        ragged_paged_attention,
        ragged_paged_attention_ref,
    )

    r = engine.runner
    tok = engine.tokenizer
    routing = _Routing(r.cfg.is_moe)
    errs = {}
    with torch.inference_mode():
        if ragged:
            ids = tok.encode(SHORT[1])
            t = r.bucket_for(len(ids))
            tokens = r._padded(ids, t)
            ar = torch.arange(t, device=dev, dtype=torch.int32)
            pos = torch.clamp(ar, max=len(ids) - 1)[None]
            valid = (ar < len(ids))[None]
            with routing.kernel():
                lk = T.prefill(r.params, r.cfg, tokens, pos, valid,
                               attention=flash_prefill_attention)[0]
            with routing.plain(), _plain_products():
                lp = T.prefill(r.params, r.cfg, tokens, pos, valid,
                               attention=prefill_attention_ref)[0]
            errs["prefill"] = routing.report(
                _logit_err(lk[0, :len(ids)], lp[0, :len(ids)]))

        st = _three_slots(r, tok)
        r.pre_decode_check(1)
        table = r._table()
        with routing.kernel():
            dk = r.decode_logits(st, table)
        r.decode_attn = paged_decode_attention_tp_plain
        with routing.plain(), _plain_products():
            dp = r.decode_logits(st, table)
        r.decode_attn = flash_paged_decode_attention_tp
        errs["decode"] = routing.report(_logit_err(dk[:3], dp[:3]))

        if ragged:
            long_ids = tok.encode(LONG)
            job = r.ragged_begin(long_ids, 5, st)
            chunk, ctx_arr, _, wp = r._ragged_provision(job, 1)
            table = r._table(wp)
            ctoks = torch.from_numpy(chunk[0]).to(dev)
            with routing.kernel():
                rk, _ = r.ragged_logits(st, table, len(long_ids), 5,
                                        ctx_arr[0], ctoks)
            r.ragged_attn = ragged_paged_attention_ref
            with routing.plain(), _plain_products():
                rp, n = r.ragged_logits(st, table, len(long_ids), 5,
                                        ctx_arr[0], ctoks)
            r.ragged_attn = ragged_paged_attention
            rows = [0, 1, 2, r.max_slots]  # live decode rows + the chunk row
            errs["ragged"] = routing.report(_logit_err(rk[rows], rp[rows]))
            r.ragged_abort(job)
    return errs


def _event_timed(kernel, spans: list):
    """``kernel`` wrapped to record a pair of CUDA events around each call
    into ``spans``."""
    def timed(*a, **kw):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = kernel(*a, **kw)
        ev1.record()
        spans.append((ev0, ev1))
        return out
    return timed


def decode_step_timing(engine, dev, kernel=None, steps: int = 8,
                       temperature: float = 0.0, gemm: bool = False) -> dict:
    """Steady-state decode with all slots live (each sampling at
    ``temperature``): host wall time per step (ending in a synchronize)
    and, when ``kernel`` is the runner's decode attention, the GPU time it
    takes per step (its launches alone, CUDA events over the same
    steps); with ``gemm`` also kernel G's time and launches per step (its
    calls event-timed through a swapped ``T.grouped_gemm``: the events of
    an eager step also span the gaps where the card waits for the host's
    launches), and from a profiler pass over the same steps the card's
    kernel time a step and G's part of it (``device_busy_ms_per_step``,
    ``gemm_device_ms_per_step``: CUPTI's kernel durations, no gaps)."""
    r = engine.runner
    tok = engine.tokenizer
    with torch.inference_mode():
        st = r.init_state()
        for slot in range(r.max_slots):
            ids = tok.encode(SHORT[slot % len(SHORT)] + str(slot))
            first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None)
            st = r.insert(st, slot, ks, vs, plen, first, temperature, 1.0,
                          prompt_tokens=ids)
        r.decode_steps(st, steps)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.decode_steps(st, steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        spans = []
        if kernel is not None:
            seam = r.decode_attn
            r.decode_attn = _event_timed(kernel, spans)
            r.decode_steps(st, steps)
            r.decode_attn = seam
            torch.cuda.synchronize()
        gspans = []
        if gemm:
            from crowdllama_tpu_torch.models import transformer as T
            from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm

            with _swapped(T, "grouped_gemm",
                          _event_timed(grouped_gemm, gspans)):
                r.decode_steps(st, steps)
            torch.cuda.synchronize()
            # The same steps under the profiler: CUPTI's kernel durations
            # hold no host gap.
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                r.decode_steps(st, steps)
                torch.cuda.synchronize()
            device_us = {e.key: getattr(e, "device_time_total",
                                        getattr(e, "cuda_time_total", 0))
                         for e in prof.key_averages()}
    out = {"slots": r.max_slots, "temperature": temperature,
           "step_ms": step_ms, "tokens_per_s": r.max_slots * 1e3 / step_ms}
    if kernel is not None:
        out["kernel_ms_per_step"] = sum(a.elapsed_time(b)
                                        for a, b in spans) / steps
    if gemm:
        out["gemm_ms_per_step"] = sum(a.elapsed_time(b)
                                      for a, b in gspans) / steps
        out["gemm_launches_per_step"] = len(gspans) / steps
        out["device_busy_ms_per_step"] = sum(device_us.values()) / 1e3 / steps
        out["gemm_device_ms_per_step"] = sum(
            v for k, v in device_us.items() if "grouped_" in k) / 1e3 / steps
    return out


def ragged_step_timing(engine, kernel) -> dict:
    """A long prompt (LONG behind a new first page, so no prefix hit)
    prefilled alone through ragged steps of one chunk beside 3 live decode
    slots, as the scheduler dispatches them: host wall ms of each step
    (ending in a synchronize) and the GPU time of the step's ragged
    attention launches (``kernel``, the runner's ``ragged_attn``, CUDA
    events)."""
    r, tok = engine.runner, engine.tokenizer
    spans, step_ms = [], []
    with torch.inference_mode():
        st = _three_slots(r, tok)
        job = r.ragged_begin(tok.encode("Timed. " + LONG), 5, st)
        r.ragged_attn = _event_timed(kernel, spans)
        try:
            while not job.finished:
                r.pre_decode_check(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, st = r.ragged_step(st, job, 1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            r.ragged_attn = kernel
            r.ragged_abort(job)
    steps = len(step_ms)
    return {"chunk": r.ragged_chunk, "steps": steps, "step_ms": step_ms,
            "step_ms_mean": sum(step_ms) / steps,
            "attention_ms_per_step": sum(a.elapsed_time(b)
                                         for a, b in spans) / steps}


@functools.cache
def seed0_params(dev) -> dict:
    """TinyLlama-1.1B at full width and depth, random weights from seed 0
    (made on ``dev``, kept on the host: each engine copies them to its
    ranks, so no card holds a spare copy), with the EOS unembedding column
    zeroed so no stream stops early (every stream must run to max_tokens
    whatever batch it lands in)."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.engine.weights import init_params
    from crowdllama_tpu_torch.models.config import get_config

    params = init_params(get_config("tinyllama-1.1b"), seed=0, device=dev)
    params["lm_head"][:, ByteTokenizer.EOS] = 0
    return _host_tree(params)


def _host_tree(tree: dict) -> dict:
    """A parameter tree's tensors copied to the host."""
    return {k: _host_tree(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def _free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def engine_phase(dev, phase: str = "engine", model: str = TINYLLAMA,
                 params: dict | None = None) -> dict:
    """The paged engine with a bf16 pool (the default config), serving
    ``model`` (on ``params``; default TinyLlama's seed-0 weights)."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        ragged_paged_attention,
    )

    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "prefix_hit": (HIT, {})}, 32, params=params,
        model=model)
    del params
    if reqs["long"]["prompt_tokens"] <= engine.runner.ragged_chunk:
        raise AssertionError("the long prompt must exceed one ragged chunk")
    _expect_launches(summary["launches"], {"A", "B", "C"}, "paged")
    ragged_chunks = engine.scheduler.ragged_chunks
    if summary["prefix_hits"] < 1 or ragged_chunks < 1:
        raise AssertionError(f"prefix hits {summary['prefix_hits']}, ragged "
                             f"chunks {ragged_chunks}: a path was not taken")
    errs = _check_logit_errs(logits_check(engine, dev), "paged")
    ragged = ragged_step_timing(engine, ragged_paged_attention)
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    steady_sampled = decode_step_timing(engine, dev,
                                        flash_paged_decode_attention_tp,
                                        temperature=0.8)
    emit({"phase": phase, "model": model,
          "layers": engine.runner.cfg.num_layers,
          "head_dim": engine.runner.cfg.resolved_head_dim(),
          **summary, "ragged_chunks": ragged_chunks,
          "long_ttft_ms": reqs["long"]["ttft_ms"], "ragged_step": ragged,
          "logits_max_abs_err": errs, "steady_decode": steady,
          "steady_decode_sampled": steady_sampled,
          "logits_rtol": LOGIT_RTOL, "card": torch.cuda.get_device_name(0)})
    return {"launches": summary["launches"], "steady": steady,
            "ids": {k: v["ids"] for k, v in reqs.items()},
            "max_memory_allocated": summary["max_memory_allocated"]}


class _StreamLog(_IdRecorder):
    """``_IdRecorder`` that also keeps each stream decoder's token ids, in
    the order the streams started (``streams``, each a list of
    ``(host seconds, id)``), for streams served in tasks this script did
    not create (the IPC server's); ``on_first``, when set, is called as a
    stream's first token arrives (its prefill is over)."""

    def __init__(self, tok, on_first=None):
        super().__init__(tok)
        self.streams: list[list] = []
        self.on_first = on_first

    def stream_decoder(self):
        dec, log, first = super().stream_decoder(), [], self.on_first
        self.streams.append(log)

        class _Dec:
            def feed(self, token_id):
                if not log and first is not None:
                    first()
                log.append((time.perf_counter(), int(token_id)))
                return dec.feed(token_id)

        return _Dec()


def _ids(log: list) -> list[int]:
    return [t for _, t in log]


def busy_share(trace_path: str, seconds: float) -> dict:
    """The card's busy share over a ``capture_profile`` window: the union
    of the trace's CUDA kernel intervals over the window's length, the
    union over the span from the first kernel's start to the last one's
    end, the 5 kernels with the most device time, and the trace's event
    count by category."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                     for e in events if e.get("cat") == "kernel")
    cats: dict[str, int] = {}
    for e in events:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    if not kernels:
        raise AssertionError(f"the profile {trace_path} holds no CUDA "
                             f"kernel (events by category: {cats})")
    busy, end, by_name = 0.0, -1.0, {}
    for t0, t1, name in kernels:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    span = kernels[-1][1] - kernels[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"events_by_category": cats, "kernels": len(kernels),
            "busy_us": busy,
            "window_us": seconds * 1e6, "busy_share": busy / (seconds * 1e6),
            "kernel_span_us": span, "busy_share_of_span": busy / span,
            "top_kernels": [{"name": n, "device_us": us,
                             "launches": sum(1 for k in kernels
                                             if k[2] == n)}
                            for n, us in top]}


def codec_timing(iters: int = 2000) -> dict:
    """Host microseconds to encode one streamed GenerateResponse frame
    (``genresp_frame_bytes``) and to decode it (``wire.decode_payload``)."""
    from crowdllama_tpu_torch.core import wire
    from crowdllama_tpu_torch.core.messages import genresp_frame_bytes

    kw = dict(worker_id="worker-a", done=False, trace_id="trace-1")
    frame = genresp_frame_bytes(TINYLLAMA, " tok", **kw)
    t0 = time.perf_counter()
    for _ in range(iters):
        genresp_frame_bytes(TINYLLAMA, " tok", **kw)
    t1 = time.perf_counter()
    for _ in range(iters):
        wire.decode_payload(frame[4:])
    t2 = time.perf_counter()
    return {"frame_bytes": len(frame), "encode_us": (t1 - t0) * 1e6 / iters,
            "decode_us": (t2 - t1) * 1e6 / iters}


PROFILE_S = 1.0
WIRE_TOKENS = 32
# The client's line limit: an embed reply of two tinyllama vectors (2 x
# 2,048 floats as JSON) is longer than asyncio's default 64 KiB.
IPC_READ_LIMIT = 1 << 24


async def _ipc_pb(sock: str, msg):
    """One PB request over a new connection -> (reply, ms)."""
    from crowdllama_tpu_torch.core import wire

    reader, writer = await asyncio.open_unix_connection(
        sock, limit=IPC_READ_LIMIT)
    try:
        t0 = time.perf_counter()
        await wire.write_length_prefixed_pb(writer, msg)
        reply = await wire.read_length_prefixed_pb(reader, timeout=120)
        return reply, (time.perf_counter() - t0) * 1e3
    finally:
        writer.close()


async def _ipc_json(sock: str, obj: dict | bytes):
    """One JSON line (or raw bytes) over a new connection -> (the reply
    line parsed, or b"" when the server dropped the connection; ms)."""
    reader, writer = await asyncio.open_unix_connection(
        sock, limit=IPC_READ_LIMIT)
    try:
        data = (obj if isinstance(obj, bytes)
                else json.dumps(obj).encode() + b"\n")
        t0 = time.perf_counter()
        writer.write(data)
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), 120)
        ms = (time.perf_counter() - t0) * 1e3
        return (json.loads(line) if line else b""), ms
    finally:
        writer.close()


SWARM_HANDSHAKES = 5
SWARM_FRAMES = 200


async def _discover(host, dht, peer_id: str, timeout: float = 30.0):
    """The worker's Resource as DHT discovery finds it (the namespace
    key's providers, then each one's metadata)."""
    from crowdllama_tpu_torch.net.discovery import discover_peers

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for r in await discover_peers(host, dht):
            if r.peer_id == peer_id:
                return r
        await asyncio.sleep(0.2)
    raise AssertionError(f"swarm: the client did not discover {peer_id[:8]}")


async def swarm_checks(engine, log: "_StreamLog") -> dict:
    """The worker's swarm plane on the card, all port modules: a DHT
    bootstrap node, a worker ``Peer`` over ``engine`` and a client host
    with its own key, on loopback.  The client finds the worker through
    the DHT, reads its metadata (the card's name as ``gpu_model``, the
    model), times the signed handshake, then sends the PB greedy request
    (streamed) and the seeded request of the wire phase over one secure
    inference stream, borrowed from a ``StreamPool`` twice (the second
    request reuses it: no new handshake).  Both replies must be token for
    token a direct ``generate()`` of the same request.  Also the
    ``crypto_golden`` vectors on this machine's Python, and host us to
    seal one streamed frame.  Each request runs directly before and after
    it goes through the peer, so its time stands between two direct
    readings."""
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.core import wire
    from crowdllama_tpu_torch.core.messages import (
        create_generate_request,
        genresp_frame_bytes,
    )
    from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL
    from crowdllama_tpu_torch.net import crypto_golden, secure
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.net.host import StreamPool
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.utils.crypto import (
        ChaCha20Poly1305,
        Ed25519PrivateKey,
    )

    t0 = time.perf_counter()
    out: dict = {"crypto_golden": crypto_golden.check(),
                 "crypto_golden_s": time.perf_counter() - t0}
    frame = genresp_frame_bytes(TINYLLAMA, " tok", worker_id="w" * 40,
                                done=False, trace_id="t" * 16)
    aead = ChaCha20Poly1305(bytes(32))
    t0 = time.perf_counter()
    for i in range(SWARM_FRAMES):
        aead.encrypt(i.to_bytes(12, "big"), frame, None)
    out["seal_us_per_frame"] = ((time.perf_counter() - t0) * 1e6
                                / SWARM_FRAMES)
    out["frame_bytes"] = len(frame)

    greedy_prompt, (seeded_prompt, seeded_kw) = SHORT[2], SAMPLED

    async def direct(prompt: str, kw: dict) -> tuple:
        """A direct ``generate()``: (text, token ids, ms)."""
        text = ""
        t0 = time.perf_counter()
        async for chunk in engine.generate(prompt, max_tokens=WIRE_TOKENS,
                                           **kw):
            text += chunk.text
        return text, _ids(log.streams[-1]), (time.perf_counter() - t0) * 1e3

    boot_host, _ = await new_host_and_dht(Ed25519PrivateKey.generate(),
                                          listen_host="127.0.0.1")
    addr = f"127.0.0.1:{boot_host.listen_port}"
    peer = Peer(Ed25519PrivateKey.generate(), Configuration(
        listen_host="127.0.0.1", bootstrap_peers=[addr], model=TINYLLAMA),
        engine)
    client, client_dht = await new_host_and_dht(
        Ed25519PrivateKey.generate(), listen_host="127.0.0.1")
    try:
        await peer.start()
        if await client_dht.bootstrap([addr]) != 1:
            raise AssertionError("swarm: the client could not bootstrap")
        t0 = time.perf_counter()
        res = await _discover(client, client_dht, peer.peer_id)
        out["discover_ms"] = (time.perf_counter() - t0) * 1e3
        name = torch.cuda.get_device_name(0)
        if not (res.gpu_model == name and res.supported_models == [TINYLLAMA]
                and res.worker_mode and res.vram_gb > 0):
            raise AssertionError(f"swarm: metadata {res}")
        out["metadata"] = {k: getattr(res, k) for k in (
            "gpu_model", "vram_gb", "accelerator", "supported_models",
            "max_context_length", "version")}
        contact = await client_dht.find_peer(peer.peer_id)
        hs = []
        for _ in range(SWARM_HANDSHAKES):
            t0 = time.perf_counter()
            s = await client.new_stream(contact, INFERENCE_PROTOCOL)
            hs.append((time.perf_counter() - t0) * 1e3)
            s.close()
        out["handshake_ms"] = hs

        pool = StreamPool()
        streams_out = client.stats["streams_out"]
        replies: dict = {}
        for name, prompt, kw, stream in (
                ("greedy", greedy_prompt, {}, True),
                ("seeded", seeded_prompt, seeded_kw, False)):
            # Direct, through the peer, direct again: the host's spread
            # between requests is wider than the peer's cost.
            before = await direct(prompt, kw)
            s = pool.get(contact.peer_id) or await client.new_stream(
                contact, INFERENCE_PROTOCOL)
            msg = create_generate_request(TINYLLAMA, prompt, stream=stream,
                                          max_tokens=WIRE_TOKENS, **kw)
            msg.trace_id = f"swarm-{name}"
            ns0, ops0 = secure.aead_stats()
            t0 = time.perf_counter()
            await wire.write_length_prefixed_pb(s.writer, msg)
            frames = []
            while True:
                m = await wire.read_length_prefixed_pb(s.reader, timeout=120)
                frames.append(m.generate_response)
                if m.generate_response.done:
                    break
            ms = (time.perf_counter() - t0) * 1e3
            ns1, ops1 = secure.aead_stats()
            pool.put(contact.peer_id, s)
            ids = _ids(log.streams[-1])
            after = await direct(prompt, kw)
            last = frames[-1]
            replies[name] = {
                "ms": ms, "direct_ms": [before[2], after[2]],
                "frames": len(frames), "completion_tokens":
                last.completion_tokens,
                "aead_ops": ops1 - ops0,
                "aead_us_per_op": (ns1 - ns0) / 1e3 / max(1, ops1 - ops0)}
            text = "".join(f.response for f in frames)
            if not (text == before[0] == after[0]
                    and ids == before[1] == after[1]
                    and last.completion_tokens == WIRE_TOKENS
                    and last.worker_id == peer.peer_id):
                raise AssertionError(
                    f"swarm: the {name} reply through the peer differs from "
                    f"generate(): {text!r} vs {before[0]!r}")
        if not (pool.hits == 1 and pool.misses == 1
                and client.stats["streams_out"] == streams_out + 1):
            raise AssertionError(f"swarm: the second request did not reuse "
                                 f"the pooled stream: {pool.hits} hits, "
                                 f"{pool.misses} misses")
        pool.close()
        out["requests"] = replies
        out["pool"] = {"hits": pool.hits, "misses": pool.misses}
        out["worker_streams_in"] = peer.host.stats["streams_in"]
    finally:
        await client.close()
        await peer.stop()
        await boot_host.close()
        engine.obs = engine._peer = None
    return out


def wire_phase(dev) -> dict:
    """The worker's request seam on the card: the port's ``IPCServer`` on a
    Unix socket over ``TorchEngine`` (tinyllama-1.1b at full width and
    depth, paged, bf16, TinyLlama's seed-0 weights), a client speaking only
    the port's codec.  Requests one at a time on the idle engine: a PB
    GenerateRequest (greedy, 32 tokens) equal to a direct ``generate()`` of
    the same prompt, a seeded PB request (0.8, seed 1234) sent twice that
    repeats, a JSON ``prompt`` of the long prompt (kernel C), a JSON
    ``embed`` of two inputs equal to ``runner.embed_prompts`` within 1e-3
    of their scale, ``ping``, ``status`` and a frame header over the cap
    (that connection is dropped, the server keeps serving).  The golden
    frames (``core/wire_golden.py``); one request streamed through
    ``handle_streaming_frames`` (its text is the greedy reply's, the last
    frame done with 32 tokens); an IPC ``profile`` of 1 s while 4 streams
    decode (the trace's size, top kernels and the card's busy share);
    last, ``migrate()`` under 3 streams of 2-4 prompt pages: each ends in a MigrateFrame with
    its delivered tokens and chain hashes, slots and pages go idle, a new
    request is refused.  A, B and C launch, no other kernel."""
    import os
    import tempfile

    from crowdllama_tpu_torch.core import wire, wire_golden
    from crowdllama_tpu_torch.core.messages import create_generate_request
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.ipc.server import IPCServer

    golden = wire_golden.check()
    codec = codec_timing()
    greedy_prompt, (seeded_prompt, seeded_kw) = SHORT[2], SAMPLED

    async def go(tmp: str) -> dict:
        sock = os.path.join(tmp, "ipc.sock")
        engine = TorchEngine(params=seed0_params(dev), device=dev,
                             model=TINYLLAMA,
                             profile_dir=os.path.join(tmp, "profile"))
        await engine.start()
        log = _StreamLog(engine.tokenizer)
        engine.tokenizer = log
        srv = IPCServer(sock, engine)
        await srv.start()
        r, tok = engine.runner, engine.tokenizer
        out: dict = {"latency_ms": {}}
        lat = out["latency_ms"]
        try:
            _zero_launches()
            # Direct generate() on the idle engine: the reference reply.
            direct = ""
            t0 = time.perf_counter()
            async for chunk in engine.generate(greedy_prompt,
                                               max_tokens=WIRE_TOKENS):
                direct += chunk.text
            lat["direct_generate"] = (time.perf_counter() - t0) * 1e3
            direct_ids = _ids(log.streams[-1])

            reply, lat["pb_greedy"] = await _ipc_pb(
                sock, create_generate_request(TINYLLAMA, greedy_prompt,
                                              max_tokens=WIRE_TOKENS))
            gr = reply.generate_response
            if not (gr.done and gr.completion_tokens == WIRE_TOKENS
                    and gr.response == direct
                    and _ids(log.streams[-1]) == direct_ids):
                raise AssertionError(f"wire: IPC greedy reply {gr} differs "
                                     f"from generate() ({direct!r})")
            seeded = []
            for i in range(2):
                reply, lat[f"pb_seeded_{i}"] = await _ipc_pb(
                    sock, create_generate_request(
                        TINYLLAMA, seeded_prompt, max_tokens=WIRE_TOKENS,
                        **seeded_kw))
                seeded.append((reply.generate_response.response,
                               _ids(log.streams[-1])))
            if seeded[0] != seeded[1] or len(seeded[0][1]) != WIRE_TOKENS:
                raise AssertionError(f"wire: the seeded request did not "
                                     f"repeat: {seeded}")
            chunks0 = engine.scheduler.ragged_chunks
            line, lat["json_prompt_long"] = await _ipc_json(sock, {
                "type": "prompt", "text": LONG, "model": TINYLLAMA})
            if (line.get("type") != "response" or not line.get("done")
                    or engine.scheduler.ragged_chunks <= chunks0):
                raise AssertionError(f"wire: JSON prompt reply {line}")
            inputs = ["alpha beta gamma", SHORT[0]]
            line, lat["json_embed"] = await _ipc_json(sock, {
                "type": "embed", "input": inputs})
            want = r.embed_prompts([tok.encode(x) for x in inputs])
            got = torch.tensor(line["embeddings"])
            embed_err = float((got - torch.from_numpy(want)).abs().max())
            if not (got.shape == want.shape
                    and embed_err <= 1e-3 * float(abs(want).max())):
                raise AssertionError(f"wire: IPC embeddings differ from "
                                     f"embed_prompts by {embed_err}")
            pong, lat["json_ping"] = await _ipc_json(sock, {"type": "ping"})
            status, lat["json_status"] = await _ipc_json(
                sock, {"type": "status"})
            dropped, _ = await _ipc_json(
                sock, struct.pack(">I", wire.MAX_MESSAGE_SIZE + 1))
            again, _ = await _ipc_json(sock, {"type": "ping"})
            if (pong != {"type": "pong"} or status != {
                    "type": "status", "peer_id": "", "workers": []}
                    or dropped != b"" or again != {"type": "pong"}):
                raise AssertionError(f"wire: ping/status/oversized: {pong} "
                                     f"{status} {dropped!r} {again}")

            # One request streamed through handle_streaming_frames.
            t0 = time.perf_counter()
            frames, first_frame = [], None
            async for frame in engine.handle_streaming_frames(
                    create_generate_request(TINYLLAMA, greedy_prompt,
                                            max_tokens=WIRE_TOKENS,
                                            stream=True)):
                frames.append(wire.decode_payload(frame[4:]))
                first_frame = first_frame or time.perf_counter()
            first_token = log.streams[-1][0][0]
            text = "".join(f.generate_response.response for f in frames)
            last = frames[-1].generate_response
            if not (text == direct and last.done
                    and last.completion_tokens == WIRE_TOKENS):
                raise AssertionError(f"wire: streamed frames {frames}")
            out["stream"] = {"frames": len(frames),
                             "ttft_ms": (first_token - t0) * 1e3,
                             "first_frame_ms": (first_frame - t0) * 1e3,
                             "wall_ms": (time.perf_counter() - t0) * 1e3}

            # IPC profile while 4 streams decode.
            async def drive(prompt):
                async for _ in engine.generate(prompt, max_tokens=1024):
                    pass

            n0 = len(log.streams)
            tasks = [asyncio.create_task(drive(p)) for p in SHORT[:4]]
            while (len(log.streams) < n0 + 4
                   or min(len(x) for x in log.streams[n0:]) < 2):
                await asyncio.sleep(0.01)
            reply, lat["json_profile"] = await _ipc_json(sock, {
                "type": "profile", "seconds": PROFILE_S})
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if reply.get("type") != "profile":
                raise AssertionError(f"wire: profile reply {reply}")
            (trace,) = [os.path.join(reply["trace_dir"], f)
                        for f in os.listdir(reply["trace_dir"])]
            out["profile"] = {"trace": trace,
                              "trace_bytes": os.path.getsize(trace),
                              "streams": 4,
                              **busy_share(trace, PROFILE_S)}
            while any(s is not None for s in engine.scheduler.slots):
                await asyncio.sleep(0.01)

            # The swarm phase on this engine, its launches counted apart.
            wire_launches = _launches()
            _zero_launches()
            out["swarm"] = await swarm_checks(engine, log)
            out["swarm"]["launches"] = _launches()
            _set_launches({k: n + out["swarm"]["launches"][k]
                           for k, n in wire_launches.items()})

            # Migrate 3 streams once each has 4 tokens.
            free0, cached0 = len(r._free_pages), len(r._page_key)
            prompts = [SHORT[0], SHORT[1], SHORT[4]]  # 2-4 pages each
            streams: dict[int, list] = {}
            ids: dict[int, list] = {}

            async def frames_of(i, prompt):
                ids[i] = []
                _STREAM_IDS.set(ids[i])
                msg = create_generate_request(TINYLLAMA, prompt,
                                              max_tokens=1024)
                msg.trace_id = f"migrate-{i}"
                streams[i] = [wire.decode_payload(f[4:]) async for f in
                              engine.handle_streaming_frames(msg, "worker")]

            tasks = [asyncio.create_task(frames_of(i, p))
                     for i, p in enumerate(prompts)]
            while len(ids) < 3 or min(len(v) for v in ids.values()) < 4:
                await asyncio.sleep(0.005)
            moved = await engine.migrate()
            await asyncio.wait_for(asyncio.gather(*tasks), 60)
            for i, prompt in enumerate(prompts):
                last = streams[i][-1]
                mf = last.migrate_frame
                want_keys = r.chain_keys_for_prompt(tok.encode(prompt))
                if not (last.WhichOneof("message") == "migrate_frame"
                        and mf.delivered_tokens == len(ids[i])
                        and list(mf.chain_hashes) == want_keys
                        and len(want_keys) >= 2
                        and mf.page_size == r.page_size
                        and last.trace_id == f"migrate-{i}"):
                    raise AssertionError(f"wire: stream {i} ended {last} "
                                         f"after {len(ids[i])} tokens")
            idle = (all(s is None for s in engine.scheduler.slots)
                    and not r._slot_pages
                    and len(set(r._free_pages) | set(r._page_key))
                    == r.total_pages)
            refused, _ = await _ipc_json(sock, {"type": "prompt",
                                                "text": "x"})
            if not (moved == 3 and idle and refused == {
                    "type": "error",
                    "error": "worker is draining for shutdown"}):
                raise AssertionError(f"wire: migrate moved {moved}, idle "
                                     f"{idle}, then {refused}")
            out["migrate"] = {
                "moved": moved,
                "delivered_tokens": [len(ids[i]) for i in range(3)],
                "chain_hashes": [len(streams[i][-1].migrate_frame
                                     .chain_hashes) for i in range(3)],
                "free_pages": [free0, len(r._free_pages)],
                "cached_pages": [cached0, len(r._page_key)],
                "total_pages": r.total_pages}
            out["launches"] = _launches()
            out["embed_max_abs_err"] = embed_err
            out["greedy_ids"] = len(direct_ids)
            out["ragged_chunks"] = engine.scheduler.ragged_chunks - chunks0
        finally:
            await srv.stop()
            await engine.stop()
        return out

    with tempfile.TemporaryDirectory(prefix="cs") as tmp:
        if len(os.path.join(tmp, "ipc.sock")) > 100:
            raise SystemExit(f"chip_smoke: socket path under {tmp} too long")
        out = asyncio.run(go(tmp))
    _expect_launches(out["launches"], {"A", "B", "C"}, "wire")
    swarm = out.pop("swarm")
    for k in ("A", "B"):
        if not swarm["launches"][k]:
            raise AssertionError(f"swarm: kernel {k} did not launch: "
                                 f"{swarm['launches']}")
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    emit({"phase": "wire", "model": TINYLLAMA, "golden": golden,
          "codec": codec, **out, "card": card, "nvidia_smi": smi})
    emit({"phase": "swarm", "model": TINYLLAMA, **swarm, "card": card,
          "nvidia_smi": smi})
    return out


CLI_TOKENS = 16


def cli_phase(extra: tuple = ()) -> dict:
    """The worker as its users start it, on the card: ``python -m
    crowdllama_tpu_torch.cli.main start --worker-mode`` (tinyllama-1.1b,
    random weights, the default config) in a process of its own, pointed
    at a DHT bootstrap node of this process.  Once a metadata op of the
    DHT answers for it, a client host sends one GenerateRequest over a
    secure inference stream; the reply must be done and come from the
    worker whose metadata names the card.  Beside it, ``start`` (a
    consumer, ``--gateway-port``) in a process of its own on the same DHT
    node: once its ``/api/health`` lists the worker healthy, the CLI's
    ``network-status`` exits 0 naming the worker healthy and ``run
    <model> "<prompt>"`` prints a reply through the consumer's gateway
    (the gateway's /metrics then counts one 200 on /api/chat), the text
    of a greedy ``/api/chat`` of the same prompt and a newline.  Then
    SIGTERM to both: each must exit 0.  ``extra`` adds the worker's CLI
    flags."""
    import os
    import signal
    import tempfile

    from crowdllama_tpu_torch.core import wire
    from crowdllama_tpu_torch.core.messages import create_generate_request
    from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL
    from crowdllama_tpu_torch.core.resource import Resource
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    root = os.path.dirname(os.path.abspath(__file__))

    async def go(tmp: str) -> dict:
        boot, boot_dht = await new_host_and_dht(
            Ed25519PrivateKey.generate(), listen_host="127.0.0.1")
        client, client_dht = await new_host_and_dht(
            Ed25519PrivateKey.generate(), listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        err = open(os.path.join(tmp, "worker.err"), "w")
        cerr = open(os.path.join(tmp, "consumer.err"), "w")
        gport = _free_port()
        cli = (sys.executable, "-m", "crowdllama_tpu_torch.cli.main")
        t0 = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            *cli, "start", "--worker-mode", "--model", TINYLLAMA,
            "--bootstrap-peers", addr, "--key-path", tmp, *extra, cwd=root,
            stderr=err)
        os.makedirs(os.path.join(tmp, "consumer"))
        cons = await asyncio.create_subprocess_exec(
            *cli, "start", "--gateway-port", str(gport), "--bootstrap-peers",
            addr, "--key-path", os.path.join(tmp, "consumer"),
            "--listen-port", "0", cwd=root, stderr=cerr)
        out: dict = {}
        try:
            res = None
            while res is None:
                if proc.returncode is not None or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"cli: the worker did not come up "
                                         f"(rc {proc.returncode})")
                for c in boot_dht.table.contacts():
                    raw = await boot_dht.request_metadata(c)
                    if raw and Resource.from_json(raw).worker_mode:
                        res = Resource.from_json(raw)
                await asyncio.sleep(0.5)
            out["up_s"] = time.perf_counter() - t0
            out["metadata"] = {k: getattr(res, k) for k in (
                "gpu_model", "vram_gb", "supported_models", "worker_mode")}
            await client_dht.bootstrap([addr])
            contact = await client_dht.find_peer(res.peer_id)
            s = await client.new_stream(contact, INFERENCE_PROTOCOL)
            t1 = time.perf_counter()
            await wire.write_length_prefixed_pb(s.writer, create_generate_request(
                TINYLLAMA, SHORT[2], max_tokens=CLI_TOKENS))
            reply = (await wire.read_length_prefixed_pb(
                s.reader, timeout=120)).generate_response
            out["request_ms"] = (time.perf_counter() - t1) * 1e3
            s.close()
            out["reply"] = {"done": reply.done, "reason": reply.done_reason,
                            "completion_tokens": reply.completion_tokens}
            if not (reply.done and reply.done_reason in ("stop", "length")
                    and 1 <= reply.completion_tokens <= CLI_TOKENS
                    and reply.worker_id == res.peer_id
                    and res.supported_models == [TINYLLAMA]
                    and res.gpu_model == torch.cuda.get_device_name(0)):
                raise AssertionError(f"cli: reply {reply} from {res}")
            out["consumer"] = await _cli_consumer(cli, root, gport,
                                                  res.peer_id, cons)
            proc.send_signal(signal.SIGTERM)
            cons.send_signal(signal.SIGTERM)
            out["rc"] = await asyncio.wait_for(proc.wait(), 120)
            out["consumer_rc"] = await asyncio.wait_for(cons.wait(), 120)
        finally:
            for p in (proc, cons):
                if p.returncode is None:
                    p.kill()
                    await p.wait()
            err.close()
            cerr.close()
            await client.close()
            await boot.close()
        for rc, name in ((out.get("rc"), "worker"),
                         (out.get("consumer_rc"), "consumer")):
            if rc != 0:
                with open(os.path.join(tmp, f"{name}.err")) as f:
                    raise AssertionError(f"cli: the {name} exited {rc}: "
                                         f"{f.read()[-2000:]}")
        return out

    with tempfile.TemporaryDirectory(prefix="cli") as tmp:
        out = asyncio.run(go(tmp))
    emit({"phase": "cli", "model": TINYLLAMA, **out,
          "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()})
    return out


GATEWAY_TOKENS = 32
GATEWAY_STREAMS = 8
GATEWAY_CAP = 2
GATEWAY_BURST = 6
GATEWAY_BUSY_TOKENS = 256
GATEWAY_MEGA_TOKENS = 64
FRAME_ITERS = 2000
# The gateway's fixed families on /metrics.
GATEWAY_FAMILIES = (
    "crowdllama_gateway_requests_total", "crowdllama_gateway_ttfb_seconds",
    "crowdllama_gateway_hotpath_us_total", "crowdllama_gateway_shed_total",
    "crowdllama_gateway_failovers_total", "crowdllama_workers_healthy",
    "crowdllama_request_seconds", "crowdllama_ttft_seconds",
    "crowdllama_hedge_launched_total", "crowdllama_host_streams_total")


def _printable(params: dict) -> dict:
    """Zero the unembedding columns of every id but printable ASCII
    (32-126) in place: a greedy token is then one character of text."""
    lm_head = params["lm_head"]
    keep = torch.zeros(lm_head.shape[1], dtype=torch.bool,
                       device=lm_head.device)
    keep[32:127] = True
    lm_head[:, ~keep] = 0
    return params


@contextlib.contextmanager
def _printable_init():
    """While entered, every runner this process builds without weights
    makes its seed's random weights and then ``_printable`` ones: the
    relay phase's CLI worker (``cli_child`` enters it when
    ``CHIP_SMOKE_PRINTABLE`` is set) and its direct reference, so both
    hold the same weights and a greedy stream carries a character a
    token."""
    from crowdllama_tpu_torch.engine import runner

    init = runner.init_params
    runner.init_params = lambda *a, **kw: _printable(init(*a, **kw))
    try:
        yield
    finally:
        runner.init_params = init


# The depth of the gateway, kv_ship and aead_split phases' TinyLlama
# (``reduced`` on their lines): their checks are of the host's request
# path, whose eager steps cost about as much a layer.
GATEWAY_LAYERS = 8


def gateway_params(dev) -> dict:
    """TinyLlama's seed-0 weights (as ``seed0_params``) cut to
    ``GATEWAY_LAYERS`` layers, copied to the card for every engine of the
    gateway phase to share (:func:`_tiny_config` gives their config), with
    the unembedding
    columns of every id but printable ASCII (32-126) zeroed in the copy
    (the cached host weights stay the seed-0 ones): a greedy token is then
    one character of text, so a stream carries a frame per token and its
    text is as long as its token ids (the byte tokenizer renders the ids
    past 255 that random weights otherwise emit as nothing)."""
    def card(tree):
        return {k: card(v) if isinstance(v, dict) else v.to(dev, copy=True)
                for k, v in tree.items()}

    return _printable(card(_cut(seed0_params(dev), GATEWAY_LAYERS)))


def _http(port: int, method: str, path: str, body=None,
          lines: list | None = None, timeout: float = 600.0,
          headers: dict | None = None) -> dict:
    """One request over the standard library's ``http.client``: status,
    headers (lower-case names), the send time and every body line with
    its arrival time (host seconds), appended to ``lines`` as they
    come."""
    import http.client

    lines = [] if lines is None else lines
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        headers = dict(headers or {})
        if data:
            headers["Content-Type"] = "application/json"
        t0 = time.perf_counter()
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        while line := resp.readline():
            lines.append((time.perf_counter(), line))
        return {"status": resp.status, "t0": t0, "lines": lines,
                "headers": {k.lower(): v for k, v in resp.getheaders()}}
    finally:
        conn.close()


def _ndjson(r: dict) -> list[dict]:
    return [json.loads(ln) for _, ln in r["lines"] if ln.strip()]


def _sse(r: dict) -> list:
    out = []
    for _, ln in r["lines"]:
        ln = ln.decode().strip()
        if ln.startswith("data: "):
            ev = ln[len("data: "):]
            out.append(ev if ev == "[DONE]" else json.loads(ev))
    return out


def _chat_body(prompt: str, tokens: int, stream: bool, **options) -> dict:
    return {"model": TINYLLAMA, "stream": stream,
            "messages": [{"role": "user", "content": prompt}],
            "options": {"num_predict": tokens, **options}}


async def _direct(engine, prompt: str, tokens: int) -> tuple:
    """A direct greedy ``generate()``: (text, seconds to the first chunk,
    completion tokens)."""
    text, first, final = "", 0.0, None
    t0 = time.perf_counter()
    async for chunk in engine.generate(prompt, max_tokens=tokens):
        first = first or time.perf_counter() - t0
        text += chunk.text
        final = chunk
    return text, first, final.completion_tokens


async def _concurrent(gw, prompts: list[str], tokens: int) -> dict:
    """``prompts`` as streamed chats through the gateway ``gw`` at once
    (``_concurrent_port``), with what the gateway's host paid for streams
    meanwhile (pool hits and misses, handshakes and their seconds)."""
    stats, pool = gw.peer.host.stats, gw._stream_pool
    before = (pool.hits, pool.misses, stats.get("streams_out", 0),
              stats.get("handshake_ns", 0))
    out = await _concurrent_port(gw.port, prompts, tokens)
    after = (pool.hits, pool.misses, stats.get("streams_out", 0),
             stats.get("handshake_ns", 0))
    out.pop("texts")
    return {**out, "pool_hits": after[0] - before[0],
            "pool_misses": after[1] - before[1],
            "streams_dialed": after[2] - before[2],
            "handshake_s": (after[3] - before[3]) / 1e9}


def _counts(workers: list[str]) -> dict:
    """Streams per worker (its id's head)."""
    return {w[:8]: workers.count(w) for w in sorted(set(workers))}


async def _concurrent_direct(assign: list, tokens: int) -> dict:
    """The same prompts as direct ``generate()`` streams at once, each on
    the engine (``assign``: (engine, prompt)) the gateway gave it."""
    t0 = time.perf_counter()
    rs = await asyncio.gather(*(_direct(e, p, tokens) for e, p in assign))
    wall = time.perf_counter() - t0
    ttft = sorted(r[1] * 1e3 for r in rs)
    tokens_out = sum(r[2] for r in rs)
    return {"ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
            "ttft_ms": ttft, "wall_s": wall, "completion_tokens": tokens_out,
            "tokens_per_s": tokens_out / wall}


def frame_render_us(iters: int = FRAME_ITERS) -> float:
    """Host us to render one streamed chat frame as the gateway writes it
    (a decoded GenerateResponse -> Ollama JSON -> one NDJSON line)."""
    from crowdllama_tpu_torch.core import wire
    from crowdllama_tpu_torch.core.messages import genresp_frame_bytes
    from crowdllama_tpu_torch.gateway.gateway import Gateway

    resp = wire.decode_payload(genresp_frame_bytes(
        TINYLLAMA, " tok", worker_id="w" * 40, done=False)[4:]
    ).generate_response
    t0 = time.perf_counter()
    for _ in range(iters):
        json.dumps(Gateway._ollama_json(resp, True, final=False)).encode() \
            + b"\n"
    return (time.perf_counter() - t0) * 1e6 / iters


def _flush_us_per_frame(gw, tids: set, frames: dict) -> list[float]:
    """Host us per NDJSON frame the gateway wrote (each request's
    ``stream_flush`` span over its frames)."""
    out = []
    for rec in gw.obs.trace.snapshot()["traces"]:
        if rec["trace_id"] in tids:
            flush = [s["dur_us"] for s in rec["spans"]
                     if s["name"] == "stream_flush"]
            if flush and frames.get(rec["trace_id"]):
                out.append(flush[0] / frames[rec["trace_id"]])
    return sorted(out)


async def _wait_routable(pm, ids: set, timeout: float = 90.0,
                         rediscover: bool = False) -> None:
    """Wait until the peer manager ``pm`` routes to every worker of
    ``ids``.  With ``rediscover`` each poll runs a discovery round at
    once: a worker joining a settled swarm is otherwise found only when
    the consumer's discovery, backed off up to 8x its interval while
    nothing new appeared, next runs."""
    deadline = time.monotonic() + timeout
    while not ids <= {p.peer_id for p in pm.get_healthy_peers()
                      if p.is_worker and not p.resource.draining}:
        if time.monotonic() > deadline:
            raise AssertionError(f"gateway: workers {ids} not routable")
        if rediscover:
            await pm.run_discovery_once()
        await asyncio.sleep(0.1)


def gateway_phase(dev) -> tuple[dict, dict]:
    """The consumer side on the card, all port modules on 127.0.0.1: a DHT
    bootstrap node, two workers (``Peer`` over ``TorchEngine``,
    tinyllama-1.1b paged bf16, eager, on one set of ``gateway_params``
    shared on the card, cut to ``GATEWAY_LAYERS`` layers), a consumer
    ``Peer`` and its ``Gateway``; the client is the standard library's
    ``http.client``.  Launch counts are
    zeroed once the workers are routable and read after the eager part.
    Checks: a greedy ``/api/chat`` of 32 tokens, not streamed and
    streamed, whose text and token ids equal a direct ``generate()`` of
    the same prompt on the worker that served it, and the CLI's ``run``
    through this gateway printing that text; a seeded request sent
    twice that repeats; ``/v1/chat/completions`` as SSE (the greedy text,
    ``[DONE]`` last); ``/api/generate`` equal to ``generate()``;
    ``/api/embed`` within 1e-3 of the runner's embeddings; ``/api/tags``
    and ``/api/health`` listing both workers; ``/metrics`` carrying the
    gateway families; ``/debug/trace/{id}`` stitched with the worker's
    spans; a burst of 6 over an admission cap of 2 answered 503 with a
    ``Retry-After`` of 1-2 s.  Reports: TTFB, median and max, and
    tokens/s of 8 concurrent streamed chats through the gateway, on the
    pool the sequential checks left (cold, most streams dialed fresh) and
    again on the pool that batch filled, beside 8 direct ``generate()``
    streams sent at once to the engines the gateway chose (with the pool
    hits, dials and handshake seconds of each batch); host us per NDJSON
    frame (the gateway's ``stream_flush`` span over its frames, and a
    render microbenchmark); the card's busy share over a 1 s
    ``capture_profile`` while 4 streams go through the gateway, opened on
    the engine that serves the most of them.
    Then the long prompt through the gateway while both engines decode
    direct streams (kernel C), and last a stream whose worker is drained
    at its third chunk: it fails over to the other worker with the
    undisturbed stream's text.  A, B and C must have launched.

    ``gateway_megastep`` (its own line): a third worker with
    ``megastep_k=8`` (graphs captured at its start) behind the same
    gateway once the eager workers are gone; 8 concurrent streams of 64
    tokens through the gateway (on a pool a first batch filled) beside 8
    direct ``generate()`` streams on that engine, and the AEAD's us per
    seal or open under that load (the process-wide ``aead_stats``: the
    gateway's and the worker's frames).
    Returns (the gateway line, the megastep line)."""
    import os
    import tempfile

    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import FakeEngine, TorchEngine
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.net import secure
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.testing import faults
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    def key():
        return Ed25519PrivateKey.generate()

    async def go(tmp: str) -> tuple[dict, dict]:
        params = gateway_params(dev)
        boot, _ = await new_host_and_dht(key(), listen_host="127.0.0.1")
        node = dict(listen_host="127.0.0.1",
                    bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
        engines = [TorchEngine(params=params, device=dev, model=TINYLLAMA,
                               model_config=_tiny_config(params),
                               profile_dir=os.path.join(tmp, f"p{i}"))
                   for i in range(2)]
        workers = [Peer(key(), Configuration(model=TINYLLAMA, **node), e)
                   for e in engines]
        consumer = Peer(key(), Configuration(**node), FakeEngine(models=[]),
                        worker_mode=False)
        gw = Gateway(consumer, port=0, host="127.0.0.1", retry_after_s=1.0)
        started: list = []
        out: dict = {}
        mega_out: dict = {}
        try:
            for part in (*engines, *workers, consumer, gw):
                await part.start()
                started.append(part)
            logs = []
            for e in engines:
                e.tokenizer = _StreamLog(e.tokenizer)
                logs.append(e.tokenizer)
            by_id = {w.peer_id: (e, lg)
                     for w, e, lg in zip(workers, engines, logs)}
            pm = consumer.peer_manager
            t0 = time.perf_counter()
            await _wait_routable(pm, set(by_id))
            out["discover_s"] = time.perf_counter() - t0
            port = gw.port

            async def call(method, path, body=None, lines=None):
                return await asyncio.to_thread(_http, port, method, path,
                                               body, lines)

            _zero_launches()
            # Greedy chat, not streamed and streamed, against generate().
            prompt = SHORT[2]
            fmt = engines[0]._format_chat(
                [{"role": "user", "content": prompt}])
            r = await call("POST", "/api/chat",
                           _chat_body(prompt, GATEWAY_TOKENS, False))
            reply = json.loads(r["lines"][0][1])
            eng, log = by_id[reply["worker_id"]]
            gw_ids = _ids(log.streams[-1])
            text = (await _direct(eng, fmt, GATEWAY_TOKENS))[0]
            ids = _ids(log.streams[-1])
            before = {t["trace_id"] for t in gw.obs.trace.snapshot()[
                "traces"]}
            r = await call("POST", "/api/chat",
                           _chat_body(prompt, GATEWAY_TOKENS, True))
            stream = _ndjson(r)
            (stream_tid,) = {t["trace_id"] for t in gw.obs.trace.snapshot()[
                "traces"]} - before
            s_eng, s_log = by_id[stream[-1]["worker_id"]]
            stream_text = "".join(x["message"]["content"] for x in stream)
            if not (r["status"] == 200 and reply["message"]["content"] == text
                    and stream_text == text and len(text) == GATEWAY_TOKENS
                    and gw_ids == ids == _ids(s_log.streams[-1])
                    and reply["eval_count"] == stream[-1]["eval_count"]
                    == GATEWAY_TOKENS and len(stream) == GATEWAY_TOKENS + 1
                    and r["headers"]["content-type"]
                    == "application/x-ndjson"):
                raise AssertionError(f"gateway: greedy chat {reply} / "
                                     f"{stream_text!r} differs from "
                                     f"generate() {text!r}")
            out["greedy"] = {"text": text, "frames": len(stream),
                             "worker": reply["worker_id"][:8]}
            # The CLI's ``run`` through this gateway prints the same text.
            run = await _cli_command(
                (sys.executable, "-m", "crowdllama_tpu_torch.cli.main"),
                os.path.dirname(os.path.abspath(__file__)), "gateway",
                "run", TINYLLAMA, prompt, "--gateway",
                f"http://127.0.0.1:{port}", "--max-tokens",
                str(GATEWAY_TOKENS), "--temperature", "0")
            if run["stdout"] != text + "\n":
                raise AssertionError(f"gateway: run printed "
                                     f"{run['stdout']!r}, not {text!r}")
            out["cli_run"] = {"stdout": run["stdout"], "s": run["s"]}
            # A seeded request, twice.
            seeded = []
            for _ in range(2):
                r = await call("POST", "/api/chat", _chat_body(
                    SAMPLED[0], GATEWAY_TOKENS, False, **SAMPLED[1]))
                rep = json.loads(r["lines"][0][1])
                seeded.append((rep["message"]["content"],
                               _ids(by_id[rep["worker_id"]][1].streams[-1]),
                               rep["eval_count"]))
            if seeded[0] != seeded[1] or seeded[0][2] != GATEWAY_TOKENS \
                    or len(seeded[0][1]) != GATEWAY_TOKENS:
                raise AssertionError(f"gateway: the seeded request did not "
                                     f"repeat: {seeded}")
            # OpenAI SSE.
            r = await call("POST", "/v1/chat/completions", {
                "model": TINYLLAMA, "stream": True, "temperature": 0,
                "max_tokens": GATEWAY_TOKENS,
                "messages": [{"role": "user", "content": prompt}]})
            events = _sse(r)
            sse_text = "".join(ev["choices"][0]["delta"].get("content", "")
                               for ev in events[:-1])
            if not (r["headers"]["content-type"] == "text/event-stream"
                    and events[-1] == "[DONE]" and sse_text == text
                    and events[-2]["choices"][0]["finish_reason"]
                    == "length"):
                raise AssertionError(f"gateway: SSE {events[-2:]} "
                                     f"{sse_text!r}")
            # /api/generate on a raw prompt.
            r = await call("POST", "/api/generate", {
                "model": TINYLLAMA, "prompt": prompt,
                "options": {"num_predict": GATEWAY_TOKENS}})
            rep = json.loads(r["lines"][0][1])
            eng, log = by_id[rep["worker_id"]]
            gen_ids = _ids(log.streams[-1])
            gtext = (await _direct(eng, prompt, GATEWAY_TOKENS))[0]
            gids = _ids(log.streams[-1])
            if not (rep["response"] == gtext and gen_ids == gids
                    and rep["eval_count"] == GATEWAY_TOKENS):
                raise AssertionError(f"gateway: /api/generate {rep} vs "
                                     f"{gtext!r}")
            # Embeddings against the runner's.
            inputs = ["alpha beta gamma", SHORT[0]]
            r = await call("POST", "/api/embed", {"model": TINYLLAMA,
                                                  "input": inputs})
            rep = json.loads(r["lines"][0][1])
            eng, _ = by_id[rep["worker_id"]]
            want = eng.runner.embed_prompts(
                [eng.tokenizer.encode(x) for x in inputs])
            got = torch.tensor(rep["embeddings"])
            embed_err = float((got - torch.from_numpy(want)).abs().max())
            if not (got.shape == want.shape
                    and embed_err <= 1e-3 * float(abs(want).max())):
                raise AssertionError(f"gateway: embeddings differ from "
                                     f"embed_prompts by {embed_err}")
            # Tags, health, metrics, the stitched trace.
            tags = json.loads((await call("GET", "/api/tags"))["lines"][0][1])
            health = json.loads((await call(
                "GET", "/api/health"))["lines"][0][1])
            metrics = b"".join(ln for _, ln in (await call(
                "GET", "/metrics"))["lines"]).decode()
            fams = {ln.split()[2] for ln in metrics.splitlines()
                    if ln.startswith("# TYPE ")}
            r = await call("GET", f"/debug/trace/{stream_tid}")
            stitched = json.loads(b"".join(ln for _, ln in r["lines"]))
            wnode = f"worker:{stream[-1]['worker_id'][:8]}"
            names = {(s["node"], s["name"]) for s in stitched["spans"]}
            if not (tags["models"] == [{"name": TINYLLAMA,
                                        "model": TINYLLAMA}]
                    and set(health["workers"]) == set(by_id)
                    and all(w["is_healthy"]
                            for w in health["workers"].values())
                    and set(GATEWAY_FAMILIES) <= fams
                    and "crowdllama_workers_healthy 2" in metrics
                    and stitched["nodes"] == ["gateway", wnode]
                    and {(wnode, "prefill"), (wnode, "decode_step"),
                         ("gateway", "route"), ("gateway", "io_wait")}
                    <= names):
                raise AssertionError(
                    f"gateway: tags {tags}, health {health}, families "
                    f"missing {set(GATEWAY_FAMILIES) - fams}, trace "
                    f"{stitched['nodes']} {sorted(names)}")
            out["metrics_families"] = len(fams)
            out["stitched"] = {"nodes": stitched["nodes"],
                               "spans": len(stitched["spans"])}
            # A burst over the admission cap.
            gw.admission_max_inflight = GATEWAY_CAP
            burst = await asyncio.gather(*(call(
                "POST", "/api/chat", _chat_body(p, GATEWAY_TOKENS, True))
                for p in (SHORT * 2)[:GATEWAY_BURST]))
            gw.admission_max_inflight = 0
            shed = [r for r in burst if r["status"] == 503]
            ok = [r for r in burst if r["status"] == 200]
            if not (shed and len(ok) + len(shed) == GATEWAY_BURST
                    and all(1 <= int(r["headers"]["retry-after"]) <= 2
                            for r in shed)
                    and all(_ndjson(r)[-1]["done"] for r in ok)):
                raise AssertionError(
                    f"gateway: burst {[r['status'] for r in burst]}")
            out["burst"] = {"sent": GATEWAY_BURST, "cap": GATEWAY_CAP,
                            "shed": len(shed),
                            "retry_after": sorted(
                                int(r["headers"]["retry-after"])
                                for r in shed)}
            # TTFB and tokens/s: 8 concurrent chats on the streams the
            # pool holds (cold: as the sequential checks left it), again
            # on a pool the first batch filled (warm), then the same 8 as
            # direct streams on the engines the gateway chose.
            prompts = (SHORT + [HIT, SAMPLED[0]])[:GATEWAY_STREAMS]
            cold = await _concurrent(gw, prompts, GATEWAY_TOKENS)
            cold["workers"] = _counts(cold["workers"])
            before = {t["trace_id"] for t in gw.obs.trace.snapshot()[
                "traces"]}
            via = await _concurrent(gw, prompts, GATEWAY_TOKENS)
            tids = {t["trace_id"]: t for t in gw.obs.trace.snapshot()[
                "traces"] if t["trace_id"] not in before}
            direct = await _concurrent_direct(
                [(by_id[w][0], engines[0]._format_chat(
                    [{"role": "user", "content": p}]))
                 for w, p in zip(via["workers"], prompts)], GATEWAY_TOKENS)
            frames = {tid: GATEWAY_TOKENS + 1 for tid in tids}
            flush = _flush_us_per_frame(gw, set(tids), frames)
            via["workers"] = _counts(via["workers"])
            out["concurrent"] = {
                "streams": GATEWAY_STREAMS, "tokens": GATEWAY_TOKENS,
                "gateway_cold_pool": cold, "gateway": via, "direct": direct,
                "tokens_per_s_share": via["tokens_per_s"]
                / direct["tokens_per_s"],
                "ttfb_over_ttft_median": via["ttfb_ms_median"]
                / direct["ttft_ms_median"]}
            out["frame_us"] = {
                "flush_us_per_frame": flush,
                "flush_us_per_frame_median": flush[len(flush) // 2],
                "render_us": frame_render_us()}
            # Busy share: a 1 s profile while 4 streams go through, opened
            # on the dispatch thread of the engine serving the most of
            # them (a session records the kernels of the thread it opens
            # on; another thread's only sometimes, see capture_profile).
            lines = [[] for _ in range(4)]
            logs_n = [len(lg.streams) for lg in logs]
            busy_tasks = [asyncio.create_task(call(
                "POST", "/api/chat",
                _chat_body(p, GATEWAY_BUSY_TOKENS, True), lines[i]))
                for i, p in enumerate(SHORT[:4])]
            while min(len(x) for x in lines) < 2:
                await asyncio.sleep(0.01)
            served = [len(lg.streams) - n for lg, n in zip(logs, logs_n)]
            profiled = served.index(max(served))
            trace_dir = await engines[profiled].capture_profile(PROFILE_S)
            (trace,) = [os.path.join(trace_dir, f)
                        for f in os.listdir(trace_dir)]
            out["busy"] = {"streams": 4, "streams_by_engine": served,
                           "profiled_engine": profiled,
                           "trace_bytes": os.path.getsize(trace),
                           **busy_share(trace, PROFILE_S)}
            await asyncio.gather(*busy_tasks)
            # The long prompt through the gateway while both engines
            # decode direct streams: a ragged prefill (kernel C).
            chunks0 = sum(e.scheduler.ragged_chunks for e in engines)
            logs_n = [len(lg.streams) for lg in logs]
            bg = [asyncio.create_task(_direct(e, p, 96))
                  for e in engines for p in SHORT[:2]]
            while any(len(lg.streams) < n + 2 or
                      min(len(s) for s in lg.streams[n:]) < 2
                      for lg, n in zip(logs, logs_n)):
                await asyncio.sleep(0.01)
            r = await call("POST", "/api/chat", _chat_body(LONG, 8, True))
            await asyncio.gather(*bg)
            out["long"] = {"status": r["status"], "ragged_chunks": sum(
                e.scheduler.ragged_chunks for e in engines) - chunks0,
                "frames": len(_ndjson(r))}
            if r["status"] != 200 or out["long"]["ragged_chunks"] < 1:
                raise AssertionError(f"gateway: long prompt {out['long']}")
            # Failover: the serving worker drained at its third chunk.
            fo0 = gw._robust["failovers"]
            plan = faults.FaultPlan(rules=[faults.FaultRule(
                site="engine.stream_chunk", action="drain", after=2)])
            with faults.installed(plan):
                r = await call("POST", "/api/chat",
                               _chat_body(prompt, GATEWAY_TOKENS, True))
            moved = _ndjson(r)
            drained = plan.log[0][1]["worker"] if plan.log else ""
            moved_text = "".join(x["message"]["content"] for x in moved)
            if not (drained and moved_text == text
                    and moved[-1]["worker_id"] not in ("", drained)
                    and moved[-1]["eval_count"] == GATEWAY_TOKENS
                    and gw._robust["failovers"] == fo0 + 1
                    and gw.obs.metrics.migrated_streams == 1):
                raise AssertionError(
                    f"gateway: failover {plan.log} -> {moved[-1]}, text "
                    f"{moved_text!r} vs {text!r}")
            out["failover"] = {"drained": drained[:8],
                               "to": moved[-1]["worker_id"][:8],
                               "frames": len(moved),
                               "failovers": gw._robust["failovers"] - fo0}
            out["launches"] = _launches()
            out["embed_max_abs_err"] = embed_err
            out["robust"] = dict(gw._robust)

            # gateway_megastep: the eager workers leave, a megastep worker
            # joins behind the same gateway.
            for w in workers:
                pm.mark_draining(w.peer_id)
            for part in (*workers, *engines):
                await part.stop()
                started.remove(part)
            engines = workers = by_id = logs = None
            _free_card()
            mega = TorchEngine(params=params, device=dev, model=TINYLLAMA,
                               model_config=_tiny_config(params),
                               megastep_k=MEGASTEP_K, decode_chunk=8)
            t0 = time.perf_counter()
            await mega.start()
            started.append(mega)
            mega_out["start_s"] = time.perf_counter() - t0
            mworker = Peer(key(), Configuration(model=TINYLLAMA, **node),
                           mega)
            await mworker.start()
            started.append(mworker)
            await _wait_routable(pm, {mworker.peer_id}, rediscover=True)
            mprompts = (SHORT + [HIT, SAMPLED[0]])[:GATEWAY_STREAMS]
            await _concurrent(gw, mprompts, 8)  # fills the stream pool
            ns0, ops0 = secure.aead_stats()
            via = await _concurrent(gw, mprompts, GATEWAY_MEGA_TOKENS)
            ns1, ops1 = secure.aead_stats()
            direct = await _concurrent_direct(
                [(mega, mega._format_chat([{"role": "user", "content": p}]))
                 for p in mprompts], GATEWAY_MEGA_TOKENS)
            g = mega.obs_gauges()
            via["workers"] = _counts(via["workers"])
            mega_out.update({
                "megastep_k": MEGASTEP_K, "streams": GATEWAY_STREAMS,
                "tokens": GATEWAY_MEGA_TOKENS, "gateway": via,
                "direct": direct,
                "tokens_per_s_share": via["tokens_per_s"]
                / direct["tokens_per_s"],
                "aead": {"ops": ops1 - ops0, "us": (ns1 - ns0) / 1e3,
                         "us_per_op": (ns1 - ns0) / 1e3
                         / max(1, ops1 - ops0),
                         "share_of_wall": (ns1 - ns0) / 1e9
                         / via["wall_s"]},
                "duty_cycle_megastep": g["duty_cycle|dispatch=megastep"],
                "captures": mega.runner._graphs.captures})
            if not (via["completion_tokens"] == direct["completion_tokens"]
                    == GATEWAY_STREAMS * GATEWAY_MEGA_TOKENS
                    and g["duty_cycle|dispatch=megastep"] > 0):
                raise AssertionError(f"gateway_megastep: {mega_out}")
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()
        return out, mega_out

    with tempfile.TemporaryDirectory(prefix="gw") as tmp:
        out, mega_out = asyncio.run(go(tmp))
    _free_card()
    launches = out.pop("launches")
    for k in ("A", "B", "C"):
        if not launches[k]:
            raise AssertionError(f"gateway: kernel {k} did not launch: "
                                 f"{launches}")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    cut = {"num_layers": [22, GATEWAY_LAYERS]}
    line = {"phase": "gateway", "model": TINYLLAMA, "reduced": cut,
            "workers": 2, **out,
            "launches": launches, "card": card, "nvidia_smi": smi}
    mline = {"phase": "gateway_megastep", "model": TINYLLAMA,
             "reduced": cut, **mega_out,
             "card": card, "nvidia_smi": smi}
    return line, mline


# ------------------------------- KV page shipping and the replicated gateway

KV_TOKENS = 32
KV_PAIRS = 3
KV_HANDOFF_TOKENS = 64
# The drain hand-off's prompt (about 5 pages of 128 tokens), sharing no
# page with the other prompts of its phase.
HANDOFF = ("A drained worker stays up as the KV donor of the streams it "
           "migrated, so each successor fetches their pages. ") * 7
GOSSIP_INTERVAL_S = 0.5
TENANT_QUOTA = "default=1000,hot=2"


async def _evict(engine) -> None:
    """Drop every cached prefix page of ``engine`` once its slots are free
    (a finished stream's slot is released at the loop's next safe point),
    on its dispatch thread between dispatches: its next prompt starts
    cold.  With no slot live no page has a holder, so the refcounts are
    reset first: a page that was evicted once and then grown into by a
    ragged prefill or a decode step leaves its release at -1, which no
    eviction takes (the JAX runner's bookkeeping too, ROADMAP Queue 3)."""
    r = engine.runner
    t0 = time.perf_counter()
    while any(x is not None for x in engine.scheduler.slots):
        if time.perf_counter() - t0 > 30:
            raise AssertionError("kv_ship: a slot stayed busy")
        await asyncio.sleep(0.005)

    def evict(_state) -> None:
        if r._slot_pages:
            raise AssertionError(f"kv_ship: slots hold pages {r._slot_pages}")
        r._page_refs.clear()
        r._evict_cached(r.total_pages)

    await engine.scheduler.run_exclusive(evict)
    if r._prefix_index:
        raise AssertionError(f"kv_ship: {len(r._prefix_index)} cached pages "
                             "survived the eviction")


async def _direct_ids(engine, prompt: str, tokens: int, **kw) -> dict:
    """A direct greedy ``generate()`` (``kw`` may name a ``kv_donor``):
    its text and token ids, host ms from the call to the first chunk (on
    the import path the fetch is inside it), and the final chunk's fetch
    ms and fallback flag."""
    log = engine.tokenizer
    n = len(log.streams)
    text, first, final = "", 0.0, None
    t0 = time.perf_counter()
    async for chunk in engine.generate(prompt, max_tokens=tokens, **kw):
        first = first or time.perf_counter() - t0
        text += chunk.text
        final = chunk
    return {"text": text, "ids": _ids(log.streams[n]),
            "ttft_ms": first * 1e3, "fetch_ms": final.kv_fetch_ns / 1e6,
            "fallback": final.kv_fallback,
            "completion_tokens": final.completion_tokens}


def _steer(gw, to: str, ids: set) -> None:
    """Route ``gw``'s requests that no affinity pins to worker ``to`` while
    it routes (``_unsteer`` undoes it)."""
    find = type(gw)._find_worker.__get__(gw)

    def pick(model, exclude=frozenset(), **kw):
        if to not in exclude:
            w = find(model, exclude=exclude | (ids - {to}), **kw)
            if w is not None:
                return w
        return find(model, exclude=exclude, **kw)

    gw._find_worker = pick


def _unsteer(gw) -> None:
    gw.__dict__.pop("_find_worker", None)


async def _chat(gw, messages: list, tokens: int, lines=None,
                tenant: str = "") -> dict:
    """A streamed ``/api/chat`` through ``gw``: its status, text, worker
    and the gateway's raw reply."""
    body = {"model": TINYLLAMA, "stream": True, "messages": messages,
            "options": {"num_predict": tokens}}
    r = await asyncio.to_thread(_http, gw.port, "POST", "/api/chat", body,
                                lines, 600.0,
                                {"X-Tenant": tenant} if tenant else None)
    frames = _ndjson(r) if r["status"] == 200 else []
    return {"status": r["status"], "raw": r,
            "text": "".join(x["message"]["content"] for x in frames),
            "worker": frames[-1]["worker_id"] if frames else "",
            "retry_after": r["headers"].get("retry-after")}


def _same_share(a: list[int], b: list[int]) -> float:
    """Share of positions where two token streams agree."""
    return sum(x == y for x, y in zip(a, b)) / max(1, len(a))


def _kv_span_ms(worker, name: str) -> list[float]:
    return [s["dur_us"] / 1e3 for t in worker.obs.trace.snapshot()["traces"]
            for s in t["spans"] if s["name"] == name]


async def import_logits_check(engine, prompt: str, pages: int) -> dict:
    """The import route against a cold prefill, at the runner's level, on
    ``engine``'s dispatch thread: the last-position logits of ``prompt``
    prefilled as its suffix over the ``pages`` pages its chain finds in
    the prefix index (the pages a fetch imported), against those of a
    prefill of the whole prompt from an empty cache (kernel A).  bf16 (or
    int8) rounding moves them by a few per cent of their scale at most; a
    wrong page, table or offset by O(1)."""
    import numpy as np

    from crowdllama_tpu_torch.engine.runner import ModelRunner

    r = engine.runner
    ids = engine.tokenizer.encode(prompt)
    pg = r.page_size

    def check(state) -> dict:
        matched = r._match_prefix(r._chain_keys(ids, (len(ids) - 1) // pg))
        if len(matched) != pages:
            raise AssertionError(f"kv_ship: {len(matched)} cached pages "
                                 f"for the prompt, expected {pages}")
        got: list = []
        sample = r._sample_first

        def capture(logits, *args, **kwargs):
            got.append(logits.float()[0].clone())
            return sample(logits, *args, **kwargs)

        table = np.full((r.max_pages_per_slot,), r.total_pages, np.int64)
        table[:pages] = matched
        r._sample_first = capture
        try:
            with torch.inference_mode():
                r._prefill_ctx(ids, pages * pg, state,
                               torch.from_numpy(table).to(r.device), 0.0,
                               1.0, None, 0, 1.0)
                ModelRunner.prefill(r, ids, 0.0, 1.0, None)
        finally:
            del r._sample_first
        via_pages, cold = got
        return {"import_vs_cold": _logit_err(via_pages, cold),
                "prompt_tokens": len(ids), "suffix_tokens": len(ids)
                - pages * pg}

    errs = await engine.scheduler.run_exclusive(check)
    _check_logit_errs({"import_vs_cold": errs["import_vs_cold"]}, "kv_ship")
    return errs


def kv_ship_phase(dev) -> tuple[dict, dict]:
    """KV page shipping and the replicated gateway on the card, every
    module the port's own, on 127.0.0.1: a DHT node, two tinyllama-1.1b
    workers (paged bf16 at full width cut to ``GATEWAY_LAYERS`` layers,
    prefix cache on, ``kv_ship``, the printable seed-0 weights of the
    gateway phase shared on the card), and two consumers whose
    ``Gateway`` replicas (``kv_ship``, tenant quotas
    ``default=1000,hot=2``) gossip through ``GossipNode``s every 0.5 s.

    The streams a fetch must reproduce token for token are the donor's
    own: the donor serving the same prompt from its cached pages takes
    the importer's route (the pages, then the suffix prefilled over them),
    so equal pages give equal tokens.  A prefill of the whole prompt from
    an empty cache takes another route (the prompt's last chunk through
    kernel C's ragged step instead of the suffix over the pages); in bf16
    the two round apart, and random weights have near-tied logits, so its
    stream is reported as the share of tokens equal to the import's.

    kv_ship (its own line): the 1,465-token prompt as turn 1 of a chat
    through replica 1 on worker 1; its continuation through replica 1
    with the pin bypassed (as when worker 1 is saturated) lands on worker
    2, which fetches worker 1's pages: exactly the pages its chain keys
    find on the donor (11) are imported, the stream equals worker 1's
    stream of the same prompt from its cache token for token (and its
    share equal to worker 2's from an empty cache is reported), and
    kernel B launches (counts zeroed right before the continuation).
    Beside that token check, a logits check: after an import, worker 2's
    last-position logits of the turn-1 prompt over the 11 imported pages
    (the suffix prefilled over them) against a prefill of the whole
    prompt from an empty cache, within ``LOGIT_RTOL`` of their scale (an
    import fault moves them by O(1); on int8 pools too).
    Then, direct on worker 2, the turn-1 prompt from an empty cache
    without and with the donor in 3 alternated pairs: TTFT (the import
    path's includes its fetch), fetch ms, bytes, every cold stream equal
    to the first and every import equal to the donor's; the card's busy
    share over a 1 s profile of one import request; one fetch with an
    injected ``kv.serve`` error on worker 1: plain prefill, the cold
    stream, ``kv_ship_fallbacks_total`` 1.  The drain hand-off: a stream
    of a 700-byte prompt decoding on worker 1 (from its cache) through
    replica 1 migrates on ``drain()``; worker 2 fetches its pages
    (``replayed_prefill_tokens_total`` 0) and the delivered text equals
    the undrained stream's.  Last, two workers on int8 pools: the same
    fetch, direct, with B-int8 launching.  No fetch but the injected one
    may fall back.

    replicated (its own line): a continuation of the conversation through
    replica 2 lands on the worker replica 1 pinned (a gossip affinity
    hit); the hot tenant through replica 2 is admitted twice and shed
    (503, ``Retry-After``) while another tenant is admitted, and replica
    1, charged by the gossiped usage, sheds it too; the drain replica 1
    saw quarantines worker 1 on replica 2 within one gossip round (the
    ``quar/`` entry from replica 1's node); replica 1's ``mark_draining``
    calls are traced (whether each found worker 1 already held draining,
    and whether it recorded) and reported, on failure too."""
    import os
    import tempfile

    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import FakeEngine, TorchEngine
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.swarm.gossip import (
        QUARANTINE_PREFIX,
        GossipNode,
        TenantQuotas,
        parse_tenant_quotas,
    )
    from crowdllama_tpu_torch.testing import faults
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    def key():
        return Ed25519PrivateKey.generate()

    async def workers_on(boot, params, started, **kw):
        node = dict(listen_host="127.0.0.1",
                    bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
        engines = [TorchEngine(params=params, device=dev, model=TINYLLAMA,
                               model_config=_tiny_config(params),
                               kv_ship=True, **kw) for _ in range(2)]
        workers = [Peer(key(), Configuration(model=TINYLLAMA, kv_ship=True,
                                             **node), e) for e in engines]
        for part in (*engines, *workers):
            await part.start()
            started.append(part)
        for e in engines:
            e.tokenizer = _StreamLog(e.tokenizer)
        return engines, workers

    async def go(tmp: str) -> tuple[dict, dict]:
        params = gateway_params(dev)
        boot, _ = await new_host_and_dht(key(), listen_host="127.0.0.1")
        node = dict(listen_host="127.0.0.1",
                    bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
        started: list = []
        out: dict = {}
        rep: dict = {}
        try:
            (e1, e2), (w1, w2) = await workers_on(
                boot, params, started, profile_dir=tmp)
            ids = {w1.peer_id, w2.peer_id}
            consumers = [Peer(key(), Configuration(**node),
                              FakeEngine(models=[]), worker_mode=False)
                         for _ in range(2)]
            for c in consumers:
                await c.start()
                started.append(c)
            addrs = [f"127.0.0.1:{c.host.listen_port}" for c in consumers]
            quotas = [TenantQuotas(parse_tenant_quotas(TENANT_QUOTA))
                      for _ in consumers]
            gnodes = [GossipNode(c, peers=[addrs[1 - i]],
                                 interval=GOSSIP_INTERVAL_S, quotas=q)
                      for i, (c, q) in enumerate(zip(consumers, quotas))]
            gws = [Gateway(c, port=0, host="127.0.0.1", kv_ship=True,
                           gossip=g, tenant_quotas=q)
                   for c, g, q in zip(consumers, gnodes, quotas)]
            for g, gw in zip(gnodes, gws):
                g.metrics = gw.obs.metrics
                await g.start()
                started.append(g)
                await gw.start()
                started.append(gw)
            for c in consumers:
                await _wait_routable(c.peer_manager, ids)
            gw1, gw2 = gws
            m2 = e2.obs.metrics

            # Turn 1 on worker 1; the continuation's cold reference on
            # worker 2 (then its cache is emptied).
            turn1 = [{"role": "user", "content": LONG}]
            _steer(gw1, w1.peer_id, ids)
            r1 = await _chat(gw1, turn1, KV_TOKENS)
            _unsteer(gw1)
            if r1["status"] != 200 or r1["worker"] != w1.peer_id:
                raise AssertionError(f"kv_ship: turn 1 {r1['status']} on "
                                     f"{r1['worker'][:8]}")
            cont = turn1 + [{"role": "assistant", "content": r1["text"]},
                            {"role": "user", "content": "Continue."}]
            cont_prompt = e2._format_chat(cont)
            cont_ids = e2.tokenizer.encode(cont_prompt)
            covered = e1.runner.local_prefix_coverage(
                e1.runner.chain_keys_for_prompt(cont_ids))
            cold = await _direct_ids(e2, cont_prompt, KV_TOKENS)
            await _evict(e2)
            # The continuation, pin bypassed, on worker 2 with worker 1 as
            # its donor.
            gw1._affinity_get = lambda akey, model: None
            _steer(gw1, w2.peer_id, ids)
            hints0 = gw1._kv_hints
            _zero_launches()
            r2 = await _chat(gw1, cont, KV_TOKENS)
            launches = _launches()
            _unsteer(gw1)
            gw1.__dict__.pop("_affinity_get")
            n_log = e2.tokenizer.streams[-1]
            donor = await _direct_ids(e1, cont_prompt, KV_TOKENS)
            fetch = {"pages": e2.runner.kv_pages_imported,
                     "donor_pages": covered,
                     "exported": e1.runner.kv_pages_exported,
                     "bytes": m2.kv_ship["bytes"],
                     "kv_fetch_span_ms": _kv_span_ms(w2, "kv_fetch"),
                     "kv_export_span_ms": _kv_span_ms(w1, "kv_export"),
                     "prompt_tokens": len(cont_ids), "launches": launches,
                     "cold_same_share": _same_share(_ids(n_log),
                                                    cold["ids"])}
            if not (r2["status"] == 200 and r2["worker"] == w2.peer_id
                    and gw1._kv_hints == hints0 + 1
                    and covered == 11 == fetch["pages"] == fetch["exported"]
                    and _ids(n_log) == donor["ids"] and r2["text"] ==
                    donor["text"] and len(donor["ids"]) == KV_TOKENS
                    and m2.kv_ship["fallbacks"] == 0
                    and fetch["kv_fetch_span_ms"] and launches["B"] > 0):
                raise AssertionError(
                    f"kv_ship: fetch {fetch}, worker {r2['worker'][:8]}, "
                    f"ids equal {_ids(n_log) == donor['ids']}, fallbacks "
                    f"{m2.kv_ship['fallbacks']}")
            out["fetch"] = fetch

            # replicated: the conversation continued through replica 2.
            akey, _ = Gateway._affinity_key(TINYLLAMA, cont, "")
            t0 = time.perf_counter()
            while (gnodes[1].lookup_affinity(akey) or ("",))[0] \
                    != w2.peer_id:
                if time.perf_counter() - t0 > 10 * GOSSIP_INTERVAL_S:
                    raise AssertionError("replicated: the pin never "
                                         "reached replica 2")
                await asyncio.sleep(0.02)
            rep["pin_gossip_s"] = time.perf_counter() - t0
            hits0 = gw2._gossip_affinity_hits
            cont2 = cont + [{"role": "assistant", "content": r2["text"]},
                            {"role": "user", "content": "And again."}]
            r3 = await _chat(gw2, cont2, 8)
            rep["affinity"] = {"worker": r3["worker"][:8],
                               "gossip_affinity_hits":
                               gw2._gossip_affinity_hits - hits0}
            if not (r3["status"] == 200 and r3["worker"] == w2.peer_id
                    and gw2._gossip_affinity_hits >= hits0 + 1):
                raise AssertionError(f"replicated: continuation {rep}")

            # TTFT: the turn-1 prompt from an empty cache, without and with
            # the donor, alternated.
            prompt1 = e2._format_chat(turn1)
            donor1 = (await _direct_ids(e1, prompt1, KV_TOKENS))["ids"]
            pairs, cold1 = [], None
            for i in range(KV_PAIRS):
                pair = {}
                for mode in (("cold", "import") if i % 2 == 0
                             else ("import", "cold")):
                    await _evict(e2)
                    b0, p0 = m2.kv_ship["bytes"], e2.runner.kv_pages_imported
                    kw = {"kv_donor": w1.peer_id} if mode == "import" else {}
                    r = await _direct_ids(e2, prompt1, KV_TOKENS, **kw)
                    r.update(bytes=m2.kv_ship["bytes"] - b0,
                             pages=e2.runner.kv_pages_imported - p0)
                    pair[mode] = r
                cold1 = cold1 or pair["cold"]["ids"]
                if not (pair["import"]["pages"] == 11
                        and not pair["import"]["fallback"]
                        and pair["import"]["ids"] == donor1
                        and pair["cold"]["ids"] == cold1
                        and pair["cold"]["pages"] == 0):
                    raise AssertionError(f"kv_ship: pair {i}: {pair}")
                pairs.append({m: {k: v for k, v in x.items()
                                  if k not in ("ids", "text")}
                              for m, x in pair.items()})
            out["ttft_pairs"] = pairs
            out["cold_same_share"] = _same_share(donor1, cold1)
            # The card's busy share over 1 s holding one import request.
            await _evict(e2)
            prof = asyncio.create_task(e2.capture_profile(PROFILE_S))
            await asyncio.sleep(0.05)
            r = await _direct_ids(e2, prompt1, KV_TOKENS,
                                  kv_donor=w1.peer_id)
            trace_dir = await prof
            (trace,) = [os.path.join(trace_dir, f)
                        for f in os.listdir(trace_dir)]
            out["import_busy"] = {"ttft_ms": r["ttft_ms"],
                                  "fetch_ms": r["fetch_ms"],
                                  **busy_share(trace, PROFILE_S)}
            # The imported pages against a cold prefill, within the kernel
            # checks' tolerance.
            out["logits"] = await import_logits_check(e2, prompt1, 11)

            # The one deliberate fallback: kv.serve fails on worker 1.
            await _evict(e2)
            plan = faults.FaultPlan(rules=[faults.FaultRule(
                site="kv.serve", action="error", times=0,
                match={"worker": w1.peer_id})])
            p0 = e2.runner.kv_pages_imported
            with faults.installed(plan):
                r = await _direct_ids(e2, prompt1, KV_TOKENS,
                                      kv_donor=w1.peer_id)
            out["fallback"] = {"fired": len(plan.log),
                               "fallbacks": m2.kv_ship["fallbacks"],
                               "retries": m2.kv_ship["retries"],
                               "pages": e2.runner.kv_pages_imported - p0,
                               "fetch_ms": r["fetch_ms"]}
            if not (plan.log and r["fallback"] and r["ids"] == cold1
                    and m2.kv_ship["fallbacks"] == 1
                    and e2.runner.kv_pages_imported == p0):
                raise AssertionError(f"kv_ship: fallback {out['fallback']}")

            # replicated: tenant quotas, admits shared by gossip.
            say = [{"role": "user", "content": SHORT[2]}]
            hot_tasks = [asyncio.create_task(_chat(gw2, say, 4, tenant="hot"))
                         for _ in range(3)]
            # Replica 1's bucket is charged the hot tenant's admits when
            # their digest arrives (it refills at 2/s from there), so a
            # request sent to it at once is shed too.
            t0 = time.perf_counter()
            while quotas[0].cluster_admitted("hot") < 2:
                if time.perf_counter() - t0 > 10 * GOSSIP_INTERVAL_S:
                    raise AssertionError("replicated: usage not gossiped")
                await asyncio.sleep(0.001)
            hot1 = await _chat(gw1, say, 4, tenant="hot")
            hot = sorted(await asyncio.gather(*hot_tasks),
                         key=lambda x: x["status"])
            light = await _chat(gw2, say, 4, tenant="light")
            rep["tenants"] = {
                "quota": TENANT_QUOTA,
                "hot_via_2": [x["status"] for x in hot],
                "retry_after": hot[2]["retry_after"],
                "light_via_2": light["status"], "hot_via_1": hot1["status"],
                "shed_2": dict(gw2.obs.metrics.tenant_shed),
                "admitted_2": dict(gw2.obs.metrics.tenant_admitted)}
            if not ([x["status"] for x in hot] == [200, 200, 503]
                    and hot[2]["retry_after"] and light["status"] == 200
                    and hot1["status"] == 503):
                raise AssertionError(f"replicated: tenants {rep['tenants']}")

            # The drain hand-off: the undrained stream on worker 1, then the
            # same stream drained mid-decode.
            hmsgs = [{"role": "user", "content": HANDOFF}]
            _steer(gw1, w1.peer_id, ids)
            # Once cold, then the reference from worker 1's cache: the
            # route the drained stream and its successor take.
            await _chat(gw1, hmsgs, KV_HANDOFF_TOKENS)
            ref = await _chat(gw1, hmsgs, KV_HANDOFF_TOKENS)
            if ref["worker"] != w1.peer_id:
                raise AssertionError(f"kv_ship: reference on {ref['worker']}")
            hcover = e1.runner.local_prefix_coverage(
                e1.runner.chain_keys_for_prompt(e1.tokenizer.encode(
                    e1._format_chat(hmsgs))))
            # Stamp replica 1's quarantine write and its arrival on
            # replica 2.
            quar = QUARANTINE_PREFIX + w1.peer_id
            stamps: dict = {}
            record, on_entry = gnodes[0].record_quarantine, gnodes[1].on_entry

            def stamped_record(worker_id, reason="drain"):
                stamps.setdefault("recorded", time.perf_counter())
                record(worker_id, reason)

            def stamped_entry(entry):
                if entry.key == quar:
                    stamps.setdefault("applied", time.perf_counter())
                on_entry(entry)

            gnodes[0].record_quarantine = stamped_record
            gnodes[1].on_entry = stamped_entry
            # Replica 1's quarantines: whether it already held worker 1 as
            # draining (its metadata refresh got there first) and whether
            # it recorded (and so gossiped) this one.
            pm1, marks = consumers[0].peer_manager, []
            mark = pm1.mark_draining

            def traced_mark(peer_id, reason="drain"):
                info = pm1.peers.get(peer_id)
                held = bool(info is not None and getattr(
                    info.resource, "draining", False))
                ok = mark(peer_id, reason)
                marks.append({"held_draining": held, "recorded": ok})
                return ok

            pm1.mark_draining = traced_mark
            lines: list = []
            p0, f0 = e2.runner.kv_pages_imported, m2.kv_ship["fetches"]
            moving = asyncio.create_task(
                _chat(gw1, hmsgs, KV_HANDOFF_TOKENS, lines))
            while len(lines) < 8:
                await asyncio.sleep(0.005)
            t_drain = time.perf_counter()
            delivered = len(lines)
            migrated = await w1.drain()
            moved = await moving
            _unsteer(gw1)
            # Wait for the gossip record to reach replica 2 and for it to
            # stop routing to worker 1.  Where it never comes, the error
            # carries replica 1's mark_draining calls: whether each found
            # worker 1 already held draining (its early return, in both
            # packages' PeerManager, writes no record).
            def settled() -> bool:
                return "applied" in stamps and consumers[
                    1].peer_manager.is_routable(w1.peer_id, TINYLLAMA) is None

            while not settled():
                if time.perf_counter() - t_drain > 20 * GOSSIP_INTERVAL_S:
                    raise AssertionError(f"replicated: no quarantine "
                                         f"relayed {stamps} {marks}")
                await asyncio.sleep(0.01)
            pm1.mark_draining = mark
            relay_s = stamps["applied"] - stamps["recorded"]
            origin = gnodes[1].state.entries[quar].origin
            out["handoff"] = {
                "migrated": migrated, "delivered_before": delivered,
                "worker": moved["worker"][:8],
                "pages": e2.runner.kv_pages_imported - p0,
                "donor_pages": hcover,
                "fetches": m2.kv_ship["fetches"] - f0,
                "replayed_prefill_tokens": m2.replayed_prefill_tokens,
                "fallbacks": m2.kv_ship["fallbacks"],
                "migrated_streams": gw1.obs.metrics.migrated_streams}
            if not (migrated >= 1 and moved["status"] == 200
                    and delivered < KV_HANDOFF_TOKENS
                    and moved["worker"] == w2.peer_id
                    and moved["text"] == ref["text"]
                    and len(ref["text"]) == KV_HANDOFF_TOKENS
                    and out["handoff"]["pages"] == hcover > 0
                    and out["handoff"]["fetches"] == 1
                    and m2.replayed_prefill_tokens == 0
                    and m2.kv_ship["fallbacks"] == 1):
                raise AssertionError(f"kv_ship: handoff {out['handoff']}")
            rep["quarantine"] = {
                "marks": marks, "relay_s": relay_s,
                "interval_s": GOSSIP_INTERVAL_S,
                "from_replica_1": origin == gnodes[0].state.node_id}
            if not (origin == gnodes[0].state.node_id
                    and relay_s <= 2 * GOSSIP_INTERVAL_S):
                raise AssertionError(f"replicated: {rep['quarantine']}")
            rep["gossip"] = [dict(g.metrics.gossip) for g in gnodes]
            rep["rounds"] = [g.rounds for g in gnodes]

            # int8 pools: two more workers, the same fetch, direct.
            for part in reversed(started):
                await (part.stop(save=False) if isinstance(part, GossipNode)
                       else part.stop())
            started.clear()
            e1 = e2 = w1 = w2 = None
            _free_card()
            (i1, i2), (v1, v2) = await workers_on(boot, params, started,
                                                  kv_dtype="int8")
            await _direct_ids(i1, prompt1, KV_TOKENS)
            donor8 = await _direct_ids(i1, prompt1, KV_TOKENS)
            cold8 = await _direct_ids(i2, prompt1, KV_TOKENS)
            await _evict(i2)
            for t0 in range(300):  # the donor in worker 2's DHT view
                if await v2.dht.find_peer(v1.peer_id) is not None:
                    break
                await asyncio.sleep(0.05)
            _zero_launches()
            r = await _direct_ids(i2, prompt1, KV_TOKENS,
                                  kv_donor=v1.peer_id)
            launches8 = _launches()
            logits8 = await import_logits_check(i2, prompt1, 11)
            out["int8"] = {"pages": i2.runner.kv_pages_imported,
                           "logits": logits8,
                           "bytes": i2.obs.metrics.kv_ship["bytes"],
                           "ttft_ms": r["ttft_ms"], "fetch_ms": r["fetch_ms"],
                           "cold_ttft_ms": cold8["ttft_ms"],
                           "cold_same_share": _same_share(r["ids"],
                                                          cold8["ids"]),
                           "launches": launches8}
            if not (i2.runner.kv_pages_imported == 11 and not r["fallback"]
                    and r["ids"] == donor8["ids"]
                    and launches8["B_int8"] > 0 and launches8["B"] == 0):
                raise AssertionError(f"kv_ship: int8 {out['int8']}")
        finally:
            for part in reversed(started):
                await (part.stop(save=False) if isinstance(part, GossipNode)
                       else part.stop())
            await boot.close()
        return out, rep

    with tempfile.TemporaryDirectory(prefix="kv") as tmp:
        out, rep = asyncio.run(go(tmp))
    _free_card()
    card, smi = torch.cuda.get_device_name(0), nvidia_smi()
    cut = {"num_layers": [22, GATEWAY_LAYERS]}
    return ({"phase": "kv_ship", "model": TINYLLAMA, "reduced": cut, **out,
             "logits_rtol": LOGIT_RTOL, "card": card, "nvidia_smi": smi},
            {"phase": "replicated", "model": TINYLLAMA, "reduced": cut,
             "replicas": 2,
             **rep, "card": card, "nvidia_smi": smi})


# --------------------------------------------------- the native data plane

MICRO_SIZES = (64 * 1024, 256 * 1024)  # a 64 KiB frame and CHUNK


def native_phase() -> dict:
    """The native data plane: the library built from the checkout's
    source with g++ (a build failure is an error, never a quiet fallback),
    then seal and open of one frame at 64 KiB and at ``CHUNK`` (256 KiB),
    the native ``AeadSession`` against the Python ``ChaCha20Poly1305`` in
    this process: median host us of each, both paths byte-equal."""
    from crowdllama_tpu_torch import native
    from crowdllama_tpu_torch.net.secure import CHUNK
    from crowdllama_tpu_torch.utils.crypto import ChaCha20Poly1305

    t0 = time.perf_counter()
    if not native.ensure_built():
        raise AssertionError(f"native: the library did not build: "
                             f"{native.stats()['build_error']}")
    out: dict = {"phase": "native", "build_s": time.perf_counter() - t0,
                 "library": native.so_path().name, "chunk": CHUNK}
    key = bytes(range(32))

    def median_us(fn, iters: int) -> float:
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e6)
        return sorted(ts)[len(ts) // 2]

    lib = native.load()
    nonce = (0).to_bytes(12, "big")
    for size in MICRO_SIZES:
        data = bytes(i % 251 for i in range(size))
        py = ChaCha20Poly1305(key)
        ct = py.encrypt(nonce, data, None)
        sealer = native.AeadSession(lib, key)
        frames = [sealer.seal_frames(data, size)[4:] for _ in range(200)]
        if frames[0] != ct:
            raise AssertionError(f"native: seal of {size} B differs")
        seal = native.AeadSession(lib, key)
        opener, pending = native.AeadSession(lib, key), iter(frames)

        def open_next():
            if opener.open(next(pending)) != data:
                raise AssertionError(f"native: open of {size} B differs")

        row = {"native_seal_us": median_us(
                   lambda: seal.seal_frames(data, size), len(frames)),
               "native_open_us": median_us(open_next, len(frames)),
               "python_seal_us": median_us(
                   lambda: py.encrypt(nonce, data, None), 5),
               "python_open_us": median_us(
                   lambda: py.decrypt(nonce, ct, None), 5)}
        row["seal_speedup"] = row["python_seal_us"] / row["native_seal_us"]
        row["open_speedup"] = row["python_open_us"] / row["native_open_us"]
        out[f"{size // 1024}KiB"] = row
    out["envelope"] = envelope_timing(median_us)
    st = native.stats()
    if not st["enabled"] or st["fallbacks"]:
        raise AssertionError(f"native: {st}")
    out["nvidia_smi"] = nvidia_smi()
    emit(out)
    return out


ENVELOPE_SIZES = (1, 64, 4096, 64 * 1024)  # characters of text a frame


def envelope_timing(median_us) -> dict:
    """The llama.v1 envelope, native against the port's Python codec, at
    ``ENVELOPE_SIZES`` characters of text: a streamed reply frame encoded
    (``wire.encode_genresp_frame`` vs ``resp_msg`` + ``encode_frame``) and
    decoded (``decode_payload_fast`` vs ``decode_payload``), and a chat
    request encoded (``encode_genreq_frame`` vs ``create_generate_request``
    + ``encode_frame``); median host us of 300 calls each, both paths
    byte-equal.  ``native_faster_everywhere`` says whether the native
    path won every pair, the ground for the call sites' dispatch on
    every size."""
    from crowdllama_tpu_torch.core import messages, wire

    rows, wins = {}, []
    for size in ENVELOPE_SIZES:
        text = "a" * size
        resp = dict(model=TINYLLAMA, response=text, worker_id="w" * 52,
                    done=False, done_reason="", total_duration_ns=0,
                    prompt_tokens=40, completion_tokens=7,
                    created_ns=1_700_000_000_123_456_789,
                    trace_id="t" * 16, parent_span="gateway")

        def codec_resp():
            msg = messages.resp_msg(messages._generate_response(
                resp["model"], text, resp["worker_id"], False, "", 0, 40, 7,
                resp["created_ns"]))
            msg.trace_id, msg.parent_span = resp["trace_id"], "gateway"
            return wire.encode_frame(msg)

        req = dict(model=TINYLLAMA, prompt="", stream=True,
                   messages=({"role": "user", "content": text},),
                   max_tokens=64, temperature=0.0, top_p=1.0, seed=0,
                   stop=(), top_k=0, repeat_penalty=1.0)

        def codec_req():
            msg = messages.create_generate_request(**req)
            msg.trace_id, msg.parent_span = "t" * 16, "gateway"
            return wire.encode_frame(msg)

        def native_req():
            return wire.encode_genreq_frame(**req, trace_id="t" * 16,
                                            parent_span="gateway")

        frame = wire.encode_genresp_frame(**resp)
        payload = frame[4:]
        fast = wire.decode_payload_fast(payload)
        if not (frame == codec_resp() and native_req() == codec_req()
                and isinstance(fast, wire.FastBaseMessage)
                and fast.generate_response.response == text):
            raise AssertionError(f"native: the envelope of {size} "
                                 f"characters differs from the codec's")
        row = {"encode_native_us": median_us(
                   lambda: wire.encode_genresp_frame(**resp), 300),
               "encode_codec_us": median_us(codec_resp, 300),
               "decode_native_us": median_us(
                   lambda: wire.decode_payload_fast(payload), 300),
               "decode_codec_us": median_us(
                   lambda: wire.decode_payload(payload), 300),
               "request_native_us": median_us(native_req, 300),
               "request_codec_us": median_us(codec_req, 300)}
        wins += [row[f"{k}_native_us"] < row[f"{k}_codec_us"]
                 for k in ("encode", "decode", "request")]
        rows[str(size)] = row
    return {"sizes": rows, "native_faster_everywhere": all(wins)}


def cli_child(module: str, out_path: str, *argv: str) -> None:
    """Run one of the port's CLIs (``module``'s ``main(argv)``) in this
    process, as ``python -m <module> <argv>`` would, and write what only
    this process can see to ``out_path`` when it returns: its exit code,
    its native data plane's stats, its kernel launch counts since the
    last SIGUSR1 (which zeroes them), its card's peak memory (0 when it
    used none) and its AEAD totals (net/secure.py)
    at each SIGUSR1 and SIGUSR2 (which also writes the launch counts to
    ``<out_path>.snap`` at once), and for ``distill-draft`` the figures of
    ``distill_draft``'s result (``DISTILL_FIGURES``).  With
    ``CHIP_SMOKE_PRINTABLE`` set, the engines it builds hold
    ``_printable_init``'s weights.  The relay, split and distill phases
    start their processes through it."""
    import faulthandler
    import importlib
    import os
    import signal

    from crowdllama_tpu_torch import native
    from crowdllama_tpu_torch.net import secure

    marks: dict = {}

    def mark(signum, _frame):
        if signum == signal.SIGUSR1:
            _zero_launches()
            marks["start"] = secure.aead_stats()
        else:
            marks["end"] = secure.aead_stats()
            with open(out_path + ".snap", "w") as f:
                json.dump({"launches": _launches()}, f)

    signal.signal(signal.SIGUSR1, mark)
    signal.signal(signal.SIGUSR2, mark)
    # SIGQUIT prints every thread's stack (a phase that times out asks).
    faulthandler.register(signal.SIGQUIT, all_threads=True)
    result: dict = {}
    if argv and argv[0] == "distill-draft":
        from crowdllama_tpu_torch.train import distill

        run = distill.distill_draft

        def recorded(dc):
            res = run(dc)
            result.update({k: res[k] for k in DISTILL_FIGURES})
            return res

        distill.distill_draft = recorded
    main = importlib.import_module(module).main
    if os.environ.get("CHIP_SMOKE_PRINTABLE"):
        with _printable_init():
            rc = main(list(argv))
    else:
        rc = main(list(argv))
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else 0)
    with open(out_path, "w") as f:
        json.dump({"rc": rc, "native": native.stats(),
                   "launches": _launches(), "aead": marks,
                   "result": result, "max_memory_allocated": peak}, f)
    sys.exit(rc)


async def _spawn_cli(root: str, tmp: str, name: str, module: str,
                     *argv: str, env: dict | None = None):
    """``cli_child(module, ...)`` in a process of its own (cwd ``root``,
    stderr to ``<tmp>/<name>.err``), and the path it reports to."""
    import os

    out = os.path.join(tmp, f"{name}.json")
    err = open(os.path.join(tmp, f"{name}.err"), "w")
    code = ("import sys, chip_smoke; chip_smoke.cli_child(*sys.argv[1:])")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-c", code, module, out, *argv, cwd=root,
        stderr=err, env={**os.environ, **(env or {})})
    proc.err_file = err
    return proc, out


async def _stop_cli(proc, out: str, name: str, tmp: str) -> dict:
    """SIGTERM ``proc``; it must exit 0 and report through ``out``."""
    import os
    import signal

    if proc.returncode is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = await asyncio.wait_for(proc.wait(), 120)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        proc.err_file.close()
    if rc != 0 or not os.path.exists(out):
        with open(os.path.join(tmp, f"{name}.err")) as f:
            raise AssertionError(f"{name}: exited {rc}: {f.read()[-2000:]}")
    with open(out) as f:
        return json.load(f)


async def _wait_worker(gport: int, proc, timeout: float = 300.0) -> str:
    """The id of the one worker the gateway on ``gport`` lists healthy."""
    t0 = time.perf_counter()
    while True:
        if proc.returncode is not None or time.perf_counter() - t0 > timeout:
            raise AssertionError(f"the gateway on {gport} lists no healthy "
                                 f"worker (rc {proc.returncode})")
        try:
            r = await asyncio.to_thread(_http, gport, "GET", "/api/health",
                                        None, None, 5.0)
            workers = json.loads(r["lines"][0][1])["workers"]
            ok = [w for w, v in workers.items() if v.get("is_healthy")]
            if ok:
                return ok[0]
        except (OSError, IndexError, ValueError):
            pass  # not up yet
        await asyncio.sleep(0.5)


async def _concurrent_port(port: int, prompts: list[str], tokens: int,
                           timeout: float = 180.0) -> dict:
    """``prompts`` as streamed chats at once through the gateway on
    ``port``: each one's TTFB (first NDJSON line after the send), frames,
    text, the worker that served it and its completion tokens, and
    tokens/s over the whole window."""
    t0 = time.perf_counter()
    rs = await asyncio.gather(*(asyncio.to_thread(
        _http, port, "POST", "/api/chat", _chat_body(p, tokens, True), None,
        timeout) for p in prompts))
    wall = time.perf_counter() - t0
    for r in rs:
        if r["status"] != 200 or not _ndjson(r)[-1].get("done"):
            raise AssertionError(f"a concurrent stream ended {r['status']} "
                                 f"{r['lines'][-1:]}")
    last = [_ndjson(r)[-1] for r in rs]
    ttfb = sorted((r["lines"][0][0] - r["t0"]) * 1e3 for r in rs)
    tokens_out = sum(x["eval_count"] for x in last)
    return {"ttfb_ms_median": ttfb[len(ttfb) // 2], "ttfb_ms_max": ttfb[-1],
            "ttfb_ms": ttfb, "wall_s": wall, "completion_tokens": tokens_out,
            "tokens_per_s": tokens_out / wall,
            "frames": [len(_ndjson(r)) for r in rs],
            "workers": [x["worker_id"] for x in last],
            "texts": ["".join(x["message"]["content"] for x in _ndjson(r))
                      for r in rs]}


def _series(text: str) -> dict:
    """/metrics text -> {"name{labels}": value}."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#") and " " in ln:
            k, _, v = ln.rpartition(" ")
            try:
                out[k] = float(v)
            except ValueError:
                pass
    return out


def _dump_children(procs: list, tmp: str) -> None:
    """Ask each live child for its threads' stacks (SIGQUIT, see
    ``cli_child``), then print the tail of every child's stderr."""
    import glob
    import signal

    for proc, _path, _name in procs:
        if proc.returncode is None:
            proc.send_signal(signal.SIGQUIT)
    time.sleep(1.0)
    for path in sorted(glob.glob(f"{tmp}/*.err")):
        with open(path, errors="replace") as f:
            print(f"--- {path}\n{f.read()[-6000:]}", file=sys.stderr)


RELAY_BG_TOKENS = 1024


async def _ragged_on_worker(gport: int, worker, w_out: str) -> dict:
    """The long prompt through the gateway on ``gport`` while a
    ``RELAY_BG_TOKENS``-token chat decodes on the worker process, so it is
    prefilled in ragged steps beside a decoding slot (kernel C); tried
    with the long prompt sent after 0.3, 0.15 and 0.6 s until the
    worker's launch counts (``cli_child``'s snapshot at SIGUSR2) show
    C.  Both replies must be done."""
    import signal

    for delay in (0.3, 0.15, 0.6):
        bg = asyncio.create_task(asyncio.to_thread(
            _http, gport, "POST", "/api/chat",
            _chat_body(SHORT[0], RELAY_BG_TOKENS, True), None, 180.0))
        await asyncio.sleep(delay)
        long_r = await asyncio.to_thread(
            _http, gport, "POST", "/api/chat", _chat_body(LONG, 8, True),
            None, 180.0)
        bg_r = await bg
        worker.send_signal(signal.SIGUSR2)
        await asyncio.sleep(0.5)
        with open(w_out + ".snap") as f:
            launches = json.load(f)["launches"]
        long_last, bg_last = _ndjson(long_r)[-1], _ndjson(bg_r)[-1]
        if not (long_last.get("done") and bg_last.get("done")):
            raise AssertionError(f"relay: long {long_last}, bg {bg_last}")
        if launches["C"]:
            return {"delay_s": delay, "eval_count": long_last["eval_count"],
                    "bg_eval_count": bg_last["eval_count"],
                    "C": launches["C"]}
    raise AssertionError(f"relay: kernel C never launched: {launches}")


def _metrics(port: int) -> dict:
    r = _http(port, "GET", "/metrics", None, None, 30.0)
    return _series(b"".join(ln for _, ln in r["lines"]).decode())


def _native_ok(where: str, report: dict) -> dict:
    st = report["native"]
    if not st["enabled"] or any(st["fallbacks"].values()):
        raise AssertionError(f"{where}: native {st}")
    return {"enabled": st["enabled"], "fallbacks": st["fallbacks"],
            "envelope_calls": st["calls"].get("envelope", 0)}


RELAY_TOKENS = 32
RELAY_RUNGS = (
    # rung, the consumer's environment (the ladder's other rungs off)
    ("splice", {"CROWDLLAMA_TPU_NO_REVERSE": "1",
                "CROWDLLAMA_TPU_NO_PUNCH": "1"}),
    ("reverse", {}),
    ("punch", {"CROWDLLAMA_TPU_NO_REVERSE": "1"}),
)


RUNG_KIND = {"splice": "relayed", "reverse": "reversed", "punch": "punched"}


def relay_phase(dev, extra: tuple = ()) -> dict:
    """A torch-only swarm in processes of their own, each started through its
    CLI: ``python -m crowdllama_tpu_torch.cli.dht start`` (the bootstrap node,
    hosting the relay), one worker ``start --worker-mode --relay-mode always``
    (tinyllama-1.1b at full width, seed-0 random weights made printable by
    ``_printable_init``, ``--megastep-k 8``, no prefix cache) that is reachable
    only through the relay, and for each rung of the dial ladder a consumer
    ``start`` with its gateway (the three started at once, once the direct
    reference is done; each serves its rung's traffic in turn): the splice
    (reversal and punch off), connection reversal (the consumer's port
    dial-back confirmed) and a hole punch on loopback (reversal off).  Each
    rung: one greedy streamed ``/api/chat`` whose text (a character a token,
    never empty) and token count equal a direct greedy ``generate()`` of the
    same prompt on the same weights in this process (its TTFB beside the direct
    TTFT), then 8 concurrent greedy chats, each one's text equal to a direct
    ``generate()`` of its prompt.  The prefix cache is off on both sides, so
    every prompt takes the same full prefill: a prefix hit prefills through
    another attention path, whose bf16 rounding flips near-tied greedy tokens
    of random weights (with the cache on, 3 of the 8 chats of the second rung,
    which hit the first rung's pages, differed from direct).  The consumer's
    ladder counters and the worker's inbound stream kinds since it started show
    the rung taken.  Kernels A, B and C launch on the worker (counts zeroed
    before the first rung's traffic, read at its exit); every process has the
    native data plane on with no fallback and exits 0 on SIGTERM; the native
    envelope served every frame (each consumer's native envelope calls at least
    the frames its gateway streamed, the worker's at least all of
    them).  ``extra`` adds the worker's CLI flags."""
    import os
    import signal
    import tempfile

    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    root = os.path.dirname(os.path.abspath(__file__))
    main_mod = "crowdllama_tpu_torch.cli.main"
    prompt = SHORT[2]
    prompts = (SHORT + [HIT, SAMPLED[0]])[:GATEWAY_STREAMS]

    async def direct_reference() -> dict:
        with _printable_init():
            engine = TorchEngine(Configuration(
                model=TINYLLAMA, megastep_k=MEGASTEP_K,
                kv_prefix_cache=False), device=dev)
            await engine.start()
        try:
            def chat(p):
                return engine._format_chat([{"role": "user", "content": p}])

            await _direct(engine, chat(prompt), RELAY_TOKENS)  # warm
            text, ttft, n = await _direct(engine, chat(prompt), RELAY_TOKENS)
            texts = {p: (await _direct(engine, chat(p), RELAY_TOKENS))[0]
                     for p in prompts}
        finally:
            await engine.stop()
        if not (len(text) == RELAY_TOKENS and all(
                len(t) == RELAY_TOKENS for t in texts.values())):
            raise AssertionError(f"relay: a direct text is not a character "
                                 f"a token: {text!r} {texts}")
        return {"text": text, "ttft_ms": ttft * 1e3, "tokens": n,
                "texts": texts}

    async def go(tmp: str) -> dict:
        dport, wport = _free_port(), _free_port()
        addr = f"127.0.0.1:{dport}"
        dht, dht_out = await _spawn_cli(
            root, tmp, "dht", "crowdllama_tpu_torch.cli.dht", "start",
            "--port", str(dport), "--host", "127.0.0.1", "--key-path",
            os.path.join(tmp, "dht"))
        procs = [(dht, dht_out, "dht")]
        out: dict = {"rungs": {}}
        try:
            while True:  # the bootstrap node listens
                try:
                    _r, w = await asyncio.open_connection("127.0.0.1", dport)
                    w.close()
                    break
                except OSError:
                    if dht.returncode is not None:
                        raise AssertionError("relay: the dht node exited")
                    await asyncio.sleep(0.2)
            t0 = time.perf_counter()
            worker, w_out = await _spawn_cli(
                root, tmp, "worker", main_mod, "start", "--worker-mode",
                "--relay-mode", "always", "--model", TINYLLAMA,
                "--megastep-k", str(MEGASTEP_K), "--bootstrap-peers", addr,
                "--key-path", os.path.join(tmp, "w"),
                "--worker-metrics-port", str(wport), *extra,
                env={"CHIP_SMOKE_PRINTABLE": "1",
                     "CROWDLLAMA_TPU_KV_PREFIX_CACHE": "0"})
            procs.append((worker, w_out, "worker"))
            out["direct"] = await direct_reference()
            _free_card()
            print("relay: direct reference done", file=sys.stderr,
                  flush=True)
            # The rungs' consumers start at once; each serves its rung's
            # traffic in turn.
            consumers = {}
            for rung, env in RELAY_RUNGS:
                gport = _free_port()
                cons, c_out = await _spawn_cli(
                    root, tmp, f"consumer_{rung}", main_mod, "start",
                    "--gateway-port", str(gport), "--bootstrap-peers", addr,
                    "--key-path", os.path.join(tmp, f"c_{rung}"),
                    "--listen-port", "0", env=env)
                procs.append((cons, c_out, f"consumer_{rung}"))
                consumers[rung] = (gport, cons, c_out)
            zeroed, streamed = False, 0
            for rung, _env in RELAY_RUNGS:
                gport, cons, c_out = consumers[rung]
                worker_id = await _wait_worker(gport, cons)
                print(f"relay {rung}: the worker is routable", file=sys.stderr,
                      flush=True)
                if not zeroed:
                    out["worker_up_s"] = time.perf_counter() - t0
                    worker.send_signal(signal.SIGUSR1)
                    await asyncio.sleep(0.5)
                    zeroed = True
                r = await asyncio.to_thread(
                    _http, gport, "POST", "/api/chat",
                    _chat_body(prompt, RELAY_TOKENS, True), None, 180.0)
                lines = _ndjson(r)
                text = "".join(x["message"]["content"] for x in lines)
                one = {"status": r["status"], "text_equal":
                       text == out["direct"]["text"],
                       "eval_count": lines[-1].get("eval_count"),
                       "ttfb_ms": (r["lines"][0][0] - r["t0"]) * 1e3}
                conc = await _concurrent_port(gport, prompts, RELAY_TOKENS)
                if rung == "splice":
                    out["long"] = await _ragged_on_worker(gport, worker,
                                                          w_out)
                cm = await asyncio.to_thread(_metrics, gport)
                wm = await asyncio.to_thread(_metrics, wport)
                ladder = {f"{g}_{o}": cm.get(
                    f'crowdllama_dial_ladder_attempts_total{{rung="{g}",'
                    f'outcome="{o}"}}', 0.0)
                    for g in ("direct", "reverse", "punch", "splice")
                    for o in ("ok", "fail")}
                # Since the worker started: each rung's consumer is the
                # only one whose streams take its kind (a fallback is
                # relayed), and the idle ones may dial before their turn.
                kinds = {k: wm.get(f'crowdllama_host_streams_total{{kind='
                                   f'"streams_{k}_in"}}', 0.0)
                         for k in ("relayed", "reversed", "punched")}
                procs.remove((cons, c_out, f"consumer_{rung}"))
                rep = await _stop_cli(cons, c_out, f"consumer_{rung}", tmp)
                differ = [p for p, t in zip(prompts, conc.pop("texts"))
                          if t != out["direct"]["texts"][p]]
                conc["texts_equal"] = len(prompts) - len(differ)
                served_by = set(conc["workers"])
                conc["workers"] = _counts(conc["workers"])
                frames = len(lines) + sum(conc["frames"])
                streamed += frames
                out["rungs"][rung] = {
                    "single": one, "concurrent": conc, "ladder": ladder,
                    "worker_streams_in": kinds, "frames": frames,
                    "consumer_native": _native_ok(f"relay {rung} consumer",
                                                  rep)}
                if not (r["status"] == 200 and one["text_equal"]
                        and len(text) == RELAY_TOKENS and not differ
                        and out["rungs"][rung]["consumer_native"][
                            "envelope_calls"] >= frames
                        and one["eval_count"] == out["direct"]["tokens"]
                        and conc["completion_tokens"]
                        == GATEWAY_STREAMS * RELAY_TOKENS
                        and served_by == {worker_id}
                        and ladder[f"{rung}_ok"] >= 1
                        and kinds[RUNG_KIND[rung]] >= 1
                        # A failed reversal or punch falls back to the
                        # splice; the rung must carry most streams.
                        and (rung == "splice" or ladder[f"{rung}_ok"]
                             > ladder["splice_ok"])):
                    raise AssertionError(f"relay {rung}: "
                                         f"{out['rungs'][rung]}")
            for proc, path, name in reversed(list(procs)):
                procs.remove((proc, path, name))
                rep = await _stop_cli(proc, path, name, tmp)
                out[f"{name}_native"] = _native_ok(f"relay {name}", rep)
                if name == "worker":
                    out["launches"] = rep["launches"]
                    if out["worker_native"]["envelope_calls"] < streamed:
                        raise AssertionError(
                            f"relay: the worker's native envelope served "
                            f"{out['worker_native']} of {streamed} frames")
            with open(os.path.join(tmp, "dht.err")) as f:
                classes = [ln for ln in f if "address class" in ln]
            out["relay_addr_classes"] = (classes[-1].split(
                "address class: ", 1)[1].strip() if classes else "")
        except BaseException:
            _dump_children(procs, tmp)
            raise
        finally:
            for proc, path, name in procs:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
                proc.err_file.close()
        return out

    with tempfile.TemporaryDirectory(prefix="relay") as tmp:
        out = asyncio.run(go(tmp))
    _expect_launches(out["launches"], {"A", "B", "C"}, "relay")
    direct = out["direct"]
    splice = out["rungs"]["splice"]["single"]
    line = {"phase": "relay", "model": TINYLLAMA, "megastep_k": MEGASTEP_K,
            "tokens": RELAY_TOKENS, "streams": GATEWAY_STREAMS, **out,
            "ttfb_splice_over_direct": splice["ttfb_ms"] / direct["ttft_ms"],
            "card": torch.cuda.get_device_name(0),
            "nvidia_smi": nvidia_smi()}
    line["direct"] = {k: v for k, v in direct.items()
                      if k not in ("text", "texts")}
    emit(line)
    return line


SPLIT_REPS = 3


def aead_split_phase(dev) -> dict:
    """``gateway_megastep`` with the gateway in a process of its own: a
    worker (``megastep_k=8``, the gateway phase's printable seed-0
    weights) in this process behind a consumer ``start`` with its gateway
    in another, once with ``CROWDLLAMA_NO_NATIVE=1`` on both sides (the
    Python AEAD) and once without (native); the two gateways start at
    once, beside the worker, and serve in turn.  For each side, over the 8
    concurrent streams of 64 tokens: AEAD operations, us per operation
    and the AEAD's share of the wall, beside tokens/s through the gateway
    as a share of direct ``generate()`` streams on the same engine (the
    medians of ``SPLIT_REPS`` batches each; the AEAD over all of them)."""
    import os
    import signal
    import tempfile

    from crowdllama_tpu_torch import native
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.net import secure
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    root = os.path.dirname(os.path.abspath(__file__))
    prompts = (SHORT + [HIT, SAMPLED[0]])[:GATEWAY_STREAMS]
    params = gateway_params(dev)

    async def go(tmp: str) -> dict:
        boot, _ = await new_host_and_dht(Ed25519PrivateKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        # Both sides' gateways start at once, while the worker starts, and
        # are up before any timed traffic; each serves its side in turn.
        gateways = {}
        for mode in ("python", "native"):
            env = {"CROWDLLAMA_NO_NATIVE": "1"} if mode == "python" else {}
            gport = _free_port()
            gateways[mode] = (gport, *await _spawn_cli(
                root, tmp, f"gateway_{mode}",
                "crowdllama_tpu_torch.cli.main", "start",
                "--gateway-port", str(gport), "--bootstrap-peers", addr,
                "--key-path", os.path.join(tmp, f"g_{mode}"),
                "--listen-port", "0", "--relay-mode", "off", env=env))
        engine = TorchEngine(params=params, device=dev, model=TINYLLAMA,
                             model_config=_tiny_config(params),
                             megastep_k=MEGASTEP_K, decode_chunk=8)
        await engine.start()
        worker = Peer(Ed25519PrivateKey.generate(), Configuration(
            model=TINYLLAMA, listen_host="127.0.0.1", bootstrap_peers=[addr],
            relay_mode="off"), engine)
        await worker.start()
        out: dict = {}
        try:
            for gport, cons, c_out in gateways.values():
                try:
                    await _wait_worker(gport, cons)
                except BaseException:
                    _dump_children([(c[1], c[2], m)
                                    for m, c in gateways.items()], tmp)
                    raise
            chats = [engine._format_chat([{"role": "user", "content": p}])
                     for p in prompts]
            await _concurrent_direct([(engine, c) for c in chats], 8)
            direct = [await _concurrent_direct(
                [(engine, c) for c in chats], GATEWAY_MEGA_TOKENS)
                for _ in range(SPLIT_REPS)]
            direct_tps = sorted(d["tokens_per_s"] for d in direct)
            out["direct"] = {"tokens_per_s": [d["tokens_per_s"]
                                              for d in direct],
                             "ttft_ms_median": [d["ttft_ms_median"]
                                                for d in direct]}
            for mode, (gport, cons, c_out) in gateways.items():
                if mode == "python":
                    os.environ["CROWDLLAMA_NO_NATIVE"] = "1"
                else:
                    os.environ.pop("CROWDLLAMA_NO_NATIVE", None)
                try:
                    await _concurrent_port(gport, prompts, 8)  # the pool
                    cons.send_signal(signal.SIGUSR1)
                    await asyncio.sleep(0.2)
                    w0 = secure.aead_stats()
                    vias = [await _concurrent_port(gport, prompts,
                                                   GATEWAY_MEGA_TOKENS)
                            for _ in range(SPLIT_REPS)]
                    w1 = secure.aead_stats()
                    cons.send_signal(signal.SIGUSR2)
                    await asyncio.sleep(0.2)
                except BaseException:
                    _dump_children([(cons, c_out, mode)], tmp)
                    raise
                finally:
                    rep = await _stop_cli(cons, c_out, f"gateway_{mode}", tmp)
                g0, g1 = rep["aead"]["start"], rep["aead"]["end"]
                wall = sum(v["wall_s"] for v in vias)
                tps = sorted(v["tokens_per_s"] for v in vias)

                def side(ns0, ops0, ns1, ops1):
                    ops = ops1 - ops0
                    return {"ops": ops, "us_per_op": (ns1 - ns0) / 1e3
                            / max(1, ops),
                            "share_of_wall": (ns1 - ns0) / 1e9 / wall}

                out[mode] = {
                    "gateway": {"tokens_per_s": [v["tokens_per_s"]
                                                 for v in vias],
                                "ttfb_ms_median": [v["ttfb_ms_median"]
                                                   for v in vias],
                                "wall_s": wall},
                    "tokens_per_s_share": tps[len(tps) // 2]
                    / direct_tps[len(direct_tps) // 2],
                    "aead_gateway": side(*g0, *g1),
                    "aead_worker": side(*w0, *w1),
                    "gateway_native": rep["native"]["enabled"],
                    "worker_native": mode == "native"
                    and native.native_enabled()}
                if not (all(v["completion_tokens"] == GATEWAY_STREAMS
                            * GATEWAY_MEGA_TOKENS for v in vias)
                        and rep["native"]["enabled"] == (mode == "native")
                        and out[mode]["aead_gateway"]["ops"] > 0
                        and out[mode]["aead_worker"]["ops"] > 0):
                    raise AssertionError(f"aead_split {mode}: {out[mode]}")
        finally:
            os.environ.pop("CROWDLLAMA_NO_NATIVE", None)
            for _gport, cons, _c_out in gateways.values():
                if cons.returncode is None:
                    cons.kill()
                    await cons.wait()
                cons.err_file.close()
            await worker.stop()
            await engine.stop()
            await boot.close()
        return out

    with tempfile.TemporaryDirectory(prefix="split") as tmp:
        out = asyncio.run(go(tmp))
    line = {"phase": "aead_split", "model": TINYLLAMA,
            "reduced": {"num_layers": [22, GATEWAY_LAYERS]},
            "megastep_k": MEGASTEP_K, "streams": GATEWAY_STREAMS,
            "tokens": GATEWAY_MEGA_TOKENS, **out,
            "card": torch.cuda.get_device_name(0),
            "nvidia_smi": nvidia_smi()}
    emit(line)
    return line


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


async def _cli_consumer(cli: tuple, root: str, gport: int, worker_id: str,
                        cons) -> dict:
    """The CLI consumer's side of the cli phase: wait for its gateway to
    list ``worker_id`` healthy, then ``network-status`` and ``run``
    through it as subprocesses, at once; both must exit 0."""
    gateway = f"http://127.0.0.1:{gport}"
    t0 = time.perf_counter()
    while True:
        if cons.returncode is not None or time.perf_counter() - t0 > 120:
            raise AssertionError(f"cli: the consumer's gateway did not list "
                                 f"the worker (rc {cons.returncode})")
        try:
            r = await asyncio.to_thread(_http, gport, "GET", "/api/health",
                                        None, None, 5.0)
            health = json.loads(r["lines"][0][1])
            if health["workers"].get(worker_id, {}).get("is_healthy"):
                break
        except (OSError, IndexError, ValueError):
            pass  # not up yet
        await asyncio.sleep(0.5)
    out: dict = {"up_s": time.perf_counter() - t0}
    out["network_status"], out["run"] = await asyncio.gather(
        _cli_command(cli, root, "cli", "network-status", "--gateway",
                     gateway),
        _cli_command(cli, root, "cli", "run", TINYLLAMA, SHORT[2],
                     "--gateway", gateway, "--max-tokens", str(CLI_TOKENS),
                     "--temperature", "0"))
    status = out["network_status"]["stdout"]
    if not (f"{worker_id[:12]} [healthy]" in status
            and "workers: 1" in status):
        raise AssertionError(f"cli: network-status printed {status!r}")
    metrics = b"".join(ln for _, ln in (await asyncio.to_thread(
        _http, gport, "GET", "/metrics"))["lines"]).decode()
    if 'crowdllama_gateway_requests_total{path="/api/chat",status="200"} 1' \
            not in metrics:
        raise AssertionError("cli: the consumer's gateway did not count "
                             "the run's /api/chat")
    # The same greedy chat as one JSON reply: ``run`` printed its text
    # and a newline.  This worker's random weights may render as little
    # or no text (the byte tokenizer prints nothing for ids past 255); the
    # gateway phase runs ``run`` on printable weights.
    r = await asyncio.to_thread(_http, gport, "POST", "/api/chat",
                                _chat_body(SHORT[2], CLI_TOKENS, False,
                                           temperature=0))
    reply = json.loads(r["lines"][0][1])
    if not (r["status"] == 200 and reply["eval_count"] == CLI_TOKENS
            and out["run"]["stdout"] == reply["message"]["content"] + "\n"):
        raise AssertionError(f"cli: run printed {out['run']['stdout']!r}, "
                             f"/api/chat replied {reply}")
    out["run"]["eval_count"] = reply["eval_count"]
    return out


async def _cli_command(cli: tuple, root: str, phase: str, *args) -> dict:
    """One CLI command in a process of its own: rc, seconds and stdout
    (whole); it must exit 0."""
    t0 = time.perf_counter()
    p = await asyncio.create_subprocess_exec(
        *cli, *args, cwd=root, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    stdout, stderr = await asyncio.wait_for(p.communicate(), 300)
    if p.returncode != 0:
        raise AssertionError(f"{phase}: {args[0]} exited {p.returncode}: "
                             f"{stderr.decode()[-2000:]}")
    return {"rc": p.returncode, "s": time.perf_counter() - t0,
            "stdout": stdout.decode()}


def _expect_tp_launches(launches: dict, tp: int, int8: bool,
                        phase: str, layers: int = 22) -> int:
    """Per decode step one F launch per layer (the ranks on the one card
    in one grid) and no B launch; A and C (its int8 variant on int8 pools)
    once per layer per rank.  Returns the decode steps the phase ran."""
    sfx = "_int8" if int8 else ""
    f, b = launches["F" + sfx], launches["B" + sfx]
    a, c = launches["A"], launches["C" + sfx]
    if not (f > 0 and f % layers == 0 and b == 0 and a > 0
            and a % (layers * tp) == 0 and c > 0
            and c % (layers * tp) == 0):
        raise AssertionError(f"{phase}: launches {launches} are not "
                             f"{layers} F launches and no B launch per "
                             f"decode step, with A and C per rank")
    return f // layers


def _greedy_share(ids: dict, reqs: dict) -> float:
    same = [a == b for name, x in ids.items()
            if name in reqs and name != "sampled"
            for a, b in zip(x, reqs[name]["ids"])]
    return sum(same) / len(same)


def tp_phase(dev, paged: dict) -> dict:
    """The paged engine at tp=2 with both ranks on the one card, the paged
    phase's traffic: kernel F decodes (both ranks in one launch of B's
    grid), A and C run per rank."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    tp = 2
    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "prefix_hit": (HIT, {})}, 32, mesh_shape=str(tp),
        devices=[dev, dev])
    r = engine.runner
    if r.tp != tp or r.devices != [dev, dev]:
        raise AssertionError(f"tp engine runs tp={r.tp} on {r.devices}")
    if reqs["long"]["prompt_tokens"] <= r.ragged_chunk:
        raise AssertionError("the long prompt must exceed one ragged chunk")
    _expect_launches(summary["launches"], {"A", "C", "F"}, "tp")
    steps = _expect_tp_launches(summary["launches"], tp, False, "tp")
    ragged_chunks = engine.scheduler.ragged_chunks
    if summary["prefix_hits"] < 1 or ragged_chunks < 1:
        raise AssertionError(f"prefix hits {summary['prefix_hits']}, ragged "
                             f"chunks {ragged_chunks}: a path was not taken")
    errs = logits_check(engine, dev)
    for k, e in errs.items():
        if not e["max_abs_err"] <= LOGIT_RTOL_TP * e["scale"]:
            raise AssertionError(f"tp {k} logits: kernel vs plain {e}")
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    peak, peak1 = summary["max_memory_allocated"], paged[
        "max_memory_allocated"]
    if peak > TP_MEMORY_RATIO * peak1:
        raise AssertionError(f"tp={tp} peak memory {peak} B above "
                             f"{TP_MEMORY_RATIO}x tp=1's {peak1} B")
    emit({"phase": "engine_tp", "model": "tinyllama-1.1b", "layers": 22,
          "tp": r.tp, "devices": [str(d) for d in r.devices], **summary,
          "decode_steps": steps, "ragged_chunks": ragged_chunks,
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL_TP,
          "greedy_tokens_equal_to_tp1": _greedy_share(paged["ids"], reqs),
          "steady_decode": steady, "tp1_steady_decode": paged["steady"],
          "tp1_max_memory_allocated": peak1,
          "memory_ratio_to_tp1": peak / peak1,
          "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


def tp_int8_phase(dev) -> dict:
    """The tensor-parallel engine on int8 pools: 3 streams of 16 tokens
    (2 short, the long one through the ragged step), F-int8 decodes and
    C-int8 runs per rank; one decode step through F-int8 vs plain."""
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1")}, 16,
        mesh_shape="2", devices=[dev, dev], kv_dtype="int8")
    _expect_launches(summary["launches"], {"A", "C_int8", "F_int8"},
                     "tp int8")
    steps = _expect_tp_launches(summary["launches"], 2, True, "tp int8")
    errs = logits_check(engine, dev, ragged=False)
    for k, e in errs.items():
        if not e["max_abs_err"] <= LOGIT_RTOL_TP * e["scale"]:
            raise AssertionError(f"tp int8 {k} logits: kernel vs plain {e}")
    emit({"phase": "engine_tp_int8", "model": "tinyllama-1.1b", "layers": 22,
          "tp": engine.runner.tp, "kv_dtype": "int8", **summary,
          "decode_steps": steps, "logits_max_abs_err": errs,
          "logits_rtol": LOGIT_RTOL_TP,
          "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


def int8_paged_phase(dev, bf16: dict) -> dict:
    """The paged engine on int8 pools (``kv_dtype="int8"``), the bf16
    paged phase's traffic plus one seeded sampled stream sent twice:
    kernels A, B-int8 and C-int8 launch, the bf16 variants do not."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        ragged_paged_attention,
    )

    streams = {**GREEDY, "prefix_hit": (HIT, {}), "sampled": SAMPLED}
    engine, summary, reqs = run_engine(dev, streams, 32, again="sampled",
                                       kv_dtype="int8")
    if engine.runner.init_state().pool_k[0].dtype != torch.int8:
        raise AssertionError("kv_dtype='int8' did not build int8 pools")
    _expect_launches(summary["launches"], {"A", "B_int8", "C_int8"},
                     "int8 paged")
    ragged_chunks = engine.scheduler.ragged_chunks
    if summary["prefix_hits"] < 1 or ragged_chunks < 1:
        raise AssertionError(f"prefix hits {summary['prefix_hits']}, ragged "
                             f"chunks {ragged_chunks}: a path was not taken")
    errs = _check_logit_errs(logits_check(engine, dev, ragged=False),
                             "int8 paged")
    ragged = ragged_step_timing(engine, ragged_paged_attention)
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    # Greedy tokens equal to the bf16 pool's, position by position (reported:
    # int8 KV changes the logits of random weights).
    same = [a == b for name, ids in bf16["ids"].items()
            if name in reqs and name != "sampled"
            for a, b in zip(ids, reqs[name]["ids"])]
    emit({"phase": "engine_int8", "model": "tinyllama-1.1b", "layers": 22,
          "kv_dtype": "int8", **summary, "ragged_chunks": ragged_chunks,
          "long_ttft_ms": reqs["long"]["ttft_ms"], "ragged_step": ragged,
          "sampled_ids": reqs["sampled"]["ids"],
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL,
          "steady_decode": steady, "bf16_steady_decode": bf16["steady"],
          "greedy_tokens_equal_to_bf16": sum(same) / len(same),
          "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


def contiguous_logits_check(engine) -> dict:
    """One decode step through kernel D and through its plain version on
    the same state (3 live slots)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    r, tok = engine.runner, engine.tokenizer
    with torch.inference_mode():
        st = _three_slots(r, tok)
        seam = r.decode_attn
        r.decode_attn = decode_attention_plain
        dp = r.decode_logits(st)
        r.decode_attn = flash_decode_attention
        dk = r.decode_logits(st)
        r.decode_attn = seam
    return _check_logit_errs({"decode": _logit_err(dk[:3], dp[:3])},
                             "contiguous")["decode"]


def _check_chunks(engine, reqs) -> int:
    chunks = engine.scheduler.prefill_chunks
    if reqs["long"]["prompt_tokens"] <= engine.runner.prefill_chunk or \
            chunks < 2:
        raise AssertionError(f"the long prompt must take >= 2 chunks "
                             f"({chunks} chunks)")
    return chunks


def contiguous_phase(dev) -> int:
    """The contiguous-KV engine; returns kernel D's launches in its
    streams."""
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention

    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "sampled": SAMPLED}, 32, again="sampled",
        kv_layout="contiguous")
    chunks = _check_chunks(engine, reqs)
    _expect_launches(summary["launches"], {"A", "D"}, "contiguous")
    err = contiguous_logits_check(engine)
    steady = decode_step_timing(engine, dev, flash_decode_attention)
    emit({"phase": "contiguous", "model": "tinyllama-1.1b", "layers": 22,
          **summary, "prefill_chunks": chunks,
          "sampled_ids": reqs["sampled"]["ids"],
          "logits_max_abs_err": err, "logits_rtol": LOGIT_RTOL,
          "steady_decode": steady, "card": torch.cuda.get_device_name(0)})
    return summary["launches"]["D"]


def int8_contiguous_phase(dev) -> None:
    """The contiguous int8 cache: 4 greedy streams of 16 tokens, the long
    one admitted in legacy chunks.  Its decode runs the plain
    ``decode_attention_q`` (the JAX package has no Pallas kernel for it),
    so only kernel A launches."""
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1", "short2")}, 16,
        kv_layout="contiguous", kv_dtype="int8")
    chunks = _check_chunks(engine, reqs)
    _expect_launches(summary["launches"], {"A"}, "int8 contiguous")
    steady = decode_step_timing(engine, dev)
    emit({"phase": "contiguous_int8", "model": "tinyllama-1.1b", "layers": 22,
          "kv_dtype": "int8", **summary, "prefill_chunks": chunks,
          "steady_decode": steady, "card": torch.cuda.get_device_name(0)})


def llama_params(dev, layers: int | None = None):
    """llama-3-8b at full width (32 query / 8 kv heads, Dh 128, hidden
    4096, vocab 128256), random bf16 weights from seed 0 made on the card
    (~16 GB at full depth; no host copy), the EOS column zeroed as in
    :func:`seed0_params`; ``layers`` cuts the depth.  Returns (config,
    params)."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.engine.weights import init_params
    from crowdllama_tpu_torch.models.config import get_config

    cfg = get_config(LLAMA, **({} if layers is None
                               else {"num_layers": layers}))
    params = init_params(cfg, seed=0, device=dev)
    params["lm_head"][:, ByteTokenizer.EOS] = 0
    return cfg, params


def llama_phase(dev) -> dict:
    """llama-3-8b at full width and depth on the paged main path (bf16
    pool, default config): the TinyLlama paged phase's traffic and
    checks at Dh 128."""
    return engine_phase(dev, "engine_llama", LLAMA, llama_params(dev)[1])


def _cut_model(dev, model: str) -> tuple:
    """``model`` (LLAMA, GEMMA9 or DANUBE) cut to LLAMA_CUT_LAYERS layers
    at full width, its seed-0 weights made on the card: (config, params,
    its full depth)."""
    from crowdllama_tpu_torch.models.config import get_config

    if model in (GEMMA9, DANUBE):
        full = gemma2_9b_config() if model == GEMMA9 else danube_config()
        cfg = dataclasses.replace(full, num_layers=LLAMA_CUT_LAYERS)
        made = gemma2_9b_params if model == GEMMA9 else danube_params
        return cfg, made(dev, cfg), full.num_layers
    return (*llama_params(dev, LLAMA_CUT_LAYERS),
            get_config(LLAMA).num_layers)


def llama_cut_phase(dev, phase: str, ran: set[str], model: str = LLAMA,
                    **engine_kw) -> dict:
    """``model`` (llama-3-8b at Dh 128, Gemma-2-9b at Dh 256 or
    H2O-Danube-1.8B at Dh 80) cut to LLAMA_CUT_LAYERS layers at full
    width, on one more path
    (``engine_kw``: int8 pools, the contiguous layout, tp=2 on the one
    card): 2 greedy short prompts and the long one, 16 tokens each.  The
    kernels in ``ran`` launch and no other; one decode step (and on bf16
    paged pools a prefill and a ragged step) through the kernels agrees
    with the plain versions (2% of the logits' scale under tp, else 5%);
    the steady decode step is reported.  Returns the launch counts of the
    streams."""
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    cfg, params, full = _cut_model(dev, model)
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1")}, 16,
        params=params, model=model, model_config=cfg, **engine_kw)
    del params
    r = engine.runner
    int8 = engine_kw.get("kv_dtype") == "int8"
    tp = int(engine_kw.get("mesh_shape") or 1)
    _expect_launches(summary["launches"], ran, phase)
    out = {}
    if tp > 1:
        out["decode_steps"] = _expect_tp_launches(
            summary["launches"], tp, int8, phase, LLAMA_CUT_LAYERS)
    if engine_kw.get("kv_layout") == "contiguous":
        out["prefill_chunks"] = _check_chunks(engine, reqs)
        errs = {"decode": contiguous_logits_check(engine)}
        kernel = flash_decode_attention
    else:
        out["ragged_chunks"] = engine.scheduler.ragged_chunks
        if (reqs["long"]["prompt_tokens"] <= r.ragged_chunk
                or out["ragged_chunks"] < 1):
            raise AssertionError(f"{phase}: the long prompt took no ragged "
                                 f"chunk")
        errs = logits_check(engine, dev, ragged=not int8)
        kernel = flash_paged_decode_attention_tp
    rtol = LOGIT_RTOL_TP if tp > 1 else LOGIT_RTOL
    for k, e in errs.items():
        if not e["max_abs_err"] <= rtol * e["scale"]:
            raise AssertionError(f"{phase} {k} logits: kernel vs plain {e}")
    steady = decode_step_timing(engine, dev, kernel)
    kw = {k: [str(d) for d in v] if k == "devices" else v
          for k, v in engine_kw.items()}
    emit({"phase": phase, "model": model, "layers": cfg.num_layers,
          "head_dim": cfg.resolved_head_dim(),
          "reduced": {"num_layers": [full, LLAMA_CUT_LAYERS]}, **kw,
          **summary, **out, "logits_max_abs_err": errs, "logits_rtol": rtol,
          "steady_decode": steady, "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


# ------------------------------------------------------------ Gemma-2-9b

GEMMA9 = "gemma-2-9b"
GEMMA9_TOKENS = 32
# A prompt of ~6,000 byte tokens, past Gemma-2-9b's 4,096-token window,
# sent while the others decode: its ragged chunks past the window, and the
# decode steps after them, mask the oldest keys on every other layer.
GEMMA9_LONG = ("Past the sliding window the local layers mask the oldest keys "
               "of this prompt, while the global layers between them still "
               "attend to every one. ") * 42
# Predictions made before the phase's first run on the card (PERF.md,
# PR 25): the steady eager step with 8 live slots (ms), TTFT median and
# max (ms), each a range.
GEMMA9_PREDICTED = {"step_ms": [30.0, 75.0], "ttft_ms_median": [150.0, 600.0],
                    "ttft_ms_max": [800.0, 3000.0]}


def gemma2_9b_config():
    """Gemma-2-9b as Google's published ``config.json`` for
    ``google/gemma-2-9b`` gives it: hidden 3,584, intermediate 14,336, 42
    layers, 16 query and 8 kv heads of head dim 256, vocab 256,000,
    ``query_pre_attn_scalar`` 256, a window of 4,096 on every other layer,
    softcaps 50 / 30, post-norms, tied embeddings, context 8,192 (the
    port's ``gemma-2-27b`` entry widened by ``dataclasses.replace``; the
    registry stays the JAX package's)."""
    from crowdllama_tpu_torch.models.config import get_config

    return dataclasses.replace(
        get_config("gemma-2-27b"), name=GEMMA9, vocab_size=256000,
        hidden_size=3584, intermediate_size=14336, num_layers=42,
        num_heads=16, num_kv_heads=8, head_dim=256,
        query_pre_attn_scalar=256.0, embedding_multiplier=3584 ** 0.5)


GEMMA9_NORMS = ("ln1", "ln2", "post_ln1", "post_ln2")


def gemma2_9b_params(dev, cfg) -> dict:
    """Random bf16 weights from seed 0 made on the card (~18.5 GB), the
    EOS embedding row zeroed (tied: no stream stops early), and every
    RMSNorm weight zero, as Hugging Face's ``Gemma2RMSNorm`` initialises
    them (Gemma scales by 1 + w, so a scale of 1).  The port's
    ``init_params`` sets them to one, a scale of 2 on every norm: under it
    42 random layers amplify one bf16 rounding of an attention output to a
    third of the logits' scale (``rounding_probe`` measures both)."""
    from crowdllama_tpu_torch.engine.weights import init_params

    params = init_params(cfg, seed=0, device=dev)
    _zero_eos_params(params)
    for key in GEMMA9_NORMS:
        params["layers"][key].zero_()
    params["final_norm"].zero_()
    return params


def rounding_probe(engine, dev) -> dict:
    """How far one bf16 rounding moves the prefill logits: the prompt of
    ``logits_check``'s prefill through the plain route, through kernel A
    (``kernel``) and through the plain route with every attention output
    element moved by one bf16 ulp up or down at random (``one_ulp``),
    each max |gap| over the plain logits' max |logit|; on the served
    weights, and again with the norm weights at the port's init (one)."""
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import flash_prefill_attention

    r, tok = engine.runner, engine.tokenizer
    ids = tok.encode(SHORT[1])
    n, t = len(ids), r.bucket_for(len(ids))
    tokens = r._padded(ids, t)
    ar = torch.arange(t, device=dev, dtype=torch.int32)
    pos = torch.clamp(ar, max=n - 1)[None]
    valid = (ar < n)[None]
    gen = torch.Generator(device=dev).manual_seed(1)

    def one_ulp(*a, **kw):
        o = prefill_attention_ref(*a, **kw)
        sign = torch.randint(0, 2, o.shape, generator=gen, device=dev) * 2 - 1
        return (o.float() * (1 + sign * 2.0 ** -7)).to(o.dtype)

    def gaps() -> dict:
        out = {}
        for name, fn in (("plain", prefill_attention_ref),
                         ("kernel", flash_prefill_attention),
                         ("one_ulp", one_ulp)):
            out[name] = T.prefill(r.params, r.cfg, tokens, pos, valid,
                                  attention=fn)[0][0, :n]
        ref = out.pop("plain")
        return {k: float((v - ref).abs().max() / ref.abs().max())
                for k, v in out.items()}

    lp = r.params[0]
    norms = [lp["layers"][k] for k in GEMMA9_NORMS] + [lp["final_norm"]]
    with torch.inference_mode():
        served = gaps()
        kept = [w.clone() for w in norms]
        for w in norms:
            w.fill_(1)
        try:
            ones = gaps()
        finally:
            for w, k in zip(norms, kept):
                w.copy_(k)
    return {"served": served, "norms_one": ones}


def _serving_memory(cfg, weight_bytes: int, slots: int, page: int) -> dict:
    """The serving peak predicted from the configuration: the weights, the
    paged pool (every slot at the full context, and the dump page) and the
    unembedding's fp32 copy made at each call (ROADMAP Queue 1 item
    3.2)."""
    token = (cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim()
             * 2 * 2)  # bf16 K and V of every layer
    pool = (slots * cfg.max_context_length + page) * token
    unembed = cfg.vocab_size * cfg.hidden_size * 4
    return {"weights": weight_bytes, "kv_pool": pool, "kv_token": token,
            "unembed_fp32": unembed,
            "total": weight_bytes + pool + unembed}


def gemma2_phase(dev) -> dict:
    """Gemma-2-9b at full width and all 42 layers (head dim 256, the
    tensor-core tile with Q in shared memory, 32- and 64-key stages) on the
    paged main path, random bf16 weights from seed 0 made on the card: the
    engine phase's 6 short prompts and prefix hit, and a ~6,000-token
    prompt past the 4,096 window sent while they decode, 32 tokens each
    (weights: ``gemma2_9b_params``).
    A launches 42 times a prefill, B 42 a decode step and C 42 a ragged
    step, and no other kernel; one prefill, decode step and ragged step
    through the kernels agree with the plain versions within 5% of the
    logits' scale; the steady step, TTFT and the serving peak are printed
    beside their predictions.  Returns the launch counts."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        ragged_paged_attention,
    )

    cfg = gemma2_9b_config()
    t0 = time.perf_counter()
    params = gemma2_9b_params(dev, cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = _tree_bytes(params)
    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "prefix_hit": (HIT, {})}, GEMMA9_TOKENS,
        params=params, model=GEMMA9, model_config=cfg,
        max_context_length=cfg.max_context_length, long_prompt=GEMMA9_LONG)
    del params
    r = engine.runner
    phase = "engine_gemma2_9b"
    long_tokens = reqs["long"]["prompt_tokens"]
    if long_tokens <= cfg.sliding_window:
        raise AssertionError(f"{phase}: the long prompt ({long_tokens}) must "
                             f"pass the {cfg.sliding_window}-token window")
    launches = summary["launches"]
    _expect_launches(launches, {"A", "B", "C"}, phase)
    layers = cfg.num_layers
    if any(launches[k] % layers for k in ("A", "B", "C")):
        raise AssertionError(f"{phase}: A, B and C launch once a layer: "
                             f"{launches}")
    ragged_chunks = engine.scheduler.ragged_chunks
    if (summary["prefix_hits"] < 1
            or ragged_chunks * r.ragged_chunk < long_tokens):
        raise AssertionError(f"{phase}: prefix hits {summary['prefix_hits']},"
                             f" ragged chunks {ragged_chunks}: a path was "
                             f"not taken")
    errs = _check_logit_errs(logits_check(engine, dev), phase)
    probe = rounding_probe(engine, dev)
    ragged = ragged_step_timing(engine, ragged_paged_attention)
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    memory = _serving_memory(cfg, weight_bytes, r.max_slots, r.page_size)
    emit({"phase": phase, "model": GEMMA9, "layers": layers,
          "head_dim": cfg.resolved_head_dim(),
          "heads": [cfg.num_heads, cfg.num_kv_heads],
          "sliding_window": cfg.sliding_window,
          "context": cfg.max_context_length, "page": r.page_size,
          "weights_init_s": init_s, **summary,
          "launches_per_layer": {k: launches[k] // layers
                                 for k in ("A", "B", "C")},
          "ragged_chunks": ragged_chunks, "long_prompt_tokens": long_tokens,
          "long_ttft_ms": reqs["long"]["ttft_ms"], "ragged_step": ragged,
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL,
          "rounding_probe": probe,
          "steady_decode": steady, "predicted": GEMMA9_PREDICTED,
          "memory_predicted": memory,
          "memory_over_predicted": summary["max_memory_allocated"]
          / memory["total"],
          "card": nvidia_smi()})
    return launches


# ------------------------------------------------------------ H2O-Danube-1.8B

DANUBE = "h2o-danube-1.8b"
DANUBE_TOKENS = 32
# A prompt of ~6,000 byte tokens, past Danube's 4,096-token window, sent
# while the others decode: its ragged chunks past the window, and the
# decode steps after them, mask the oldest keys on every layer.
DANUBE_LONG = ("Past the sliding window every layer of this model masks the "
               "oldest keys of the prompt, so the newest 4,096 positions are "
               "all that a query sees. ") * 42
# Predictions made before the phase's first run on the card (PERF.md,
# PR 27): the steady eager step with 8 live slots (ms), TTFT median and
# max (ms), the serving peak (GB), each a range.
DANUBE_PREDICTED = {"step_ms": [12.0, 45.0], "ttft_ms_median": [100.0, 900.0],
                    "ttft_ms_max": [400.0, 3000.0],
                    "peak_gb": [12.0, 14.5]}


def danube_config():
    """H2O-Danube-1.8B as its published ``config.json`` gives it
    (``testing/hf_fixtures.py DANUBE_1_8B_CONFIG``, written out and read
    through the port's ``config_from_hf_dir``): a Mistral model, hidden
    2,560, intermediate 6,912, 24 layers, 32 query and 8 kv heads of head
    dim 80, vocab 32,000, a window of 4,096 on every layer, context
    16,384, untied embeddings."""
    import json
    import tempfile
    from pathlib import Path

    from crowdllama_tpu_torch.engine.weights import config_from_hf_dir
    from crowdllama_tpu_torch.testing.hf_fixtures import DANUBE_1_8B_CONFIG

    with tempfile.TemporaryDirectory(prefix="danube") as d:
        (Path(d) / "config.json").write_text(json.dumps(DANUBE_1_8B_CONFIG))
        return dataclasses.replace(config_from_hf_dir(d), name=DANUBE)


def danube_params(dev, cfg) -> dict:
    """Random bf16 weights from seed 0 made on the card (~3.66 GB at full
    depth), the EOS column of ``lm_head`` zeroed so no stream stops early.
    Mistral's RMSNorm scales by w, so the port's init of one is Hugging
    Face's."""
    from crowdllama_tpu_torch.engine.weights import init_params

    params = init_params(cfg, seed=0, device=dev)
    _zero_eos_params(params)
    return params


def danube_phase(dev) -> dict:
    """H2O-Danube-1.8B at full width and all 24 layers (head dim 80: the
    tensor-core tile's 96-key tiles and odd last k-step, the decode stages'
    uneven lane shares) at its published 16,384 context on the paged main
    path, random bf16 weights from seed 0 made on the card: the engine
    phase's 6 short prompts and prefix hit, and a ~6,000-token prompt past
    the 4,096 window sent while they decode, 32 tokens each.  A launches
    24 times a prefill, B 24 a decode step and C 24 a ragged step, and no
    other kernel; one prefill, decode step and ragged step through the
    kernels agree with the plain versions within 5% of the logits' scale;
    the steady step, the ragged step with C's time, TTFT and the serving
    peak are printed beside their predictions.  Returns the launch
    counts."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        ragged_paged_attention,
    )

    cfg = danube_config()
    t0 = time.perf_counter()
    params = danube_params(dev, cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = _tree_bytes(params)
    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "prefix_hit": (HIT, {})}, DANUBE_TOKENS,
        params=params, model=DANUBE, model_config=cfg,
        max_context_length=cfg.max_context_length, long_prompt=DANUBE_LONG)
    del params
    r = engine.runner
    phase = "engine_danube_1_8b"
    long_tokens = reqs["long"]["prompt_tokens"]
    if long_tokens <= cfg.sliding_window:
        raise AssertionError(f"{phase}: the long prompt ({long_tokens}) must "
                             f"pass the {cfg.sliding_window}-token window")
    launches = summary["launches"]
    _expect_launches(launches, {"A", "B", "C"}, phase)
    layers = cfg.num_layers
    if any(launches[k] % layers for k in ("A", "B", "C")):
        raise AssertionError(f"{phase}: A, B and C launch once a layer: "
                             f"{launches}")
    ragged_chunks = engine.scheduler.ragged_chunks
    if (summary["prefix_hits"] < 1
            or ragged_chunks * r.ragged_chunk < long_tokens):
        raise AssertionError(f"{phase}: prefix hits {summary['prefix_hits']},"
                             f" ragged chunks {ragged_chunks}: a path was "
                             f"not taken")
    errs = _check_logit_errs(logits_check(engine, dev), phase)
    ragged = ragged_step_timing(engine, ragged_paged_attention)
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    memory = _serving_memory(cfg, weight_bytes, r.max_slots, r.page_size)
    emit({"phase": phase, "model": DANUBE, "layers": layers,
          "head_dim": cfg.resolved_head_dim(),
          "heads": [cfg.num_heads, cfg.num_kv_heads],
          "sliding_window": cfg.sliding_window,
          "context": cfg.max_context_length, "page": r.page_size,
          "slots": r.max_slots, "weights_init_s": init_s, **summary,
          "launches_per_layer": {k: launches[k] // layers
                                 for k in ("A", "B", "C")},
          "ragged_chunks": ragged_chunks, "long_prompt_tokens": long_tokens,
          "long_ttft_ms": reqs["long"]["ttft_ms"], "ragged_step": ragged,
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL,
          "steady_decode": steady, "predicted": DANUBE_PREDICTED,
          "memory_predicted": memory,
          "memory_over_predicted": summary["max_memory_allocated"]
          / memory["total"],
          "card": nvidia_smi()})
    return launches


# ------------------------------------------------------------ HF checkpoints

HF_TOKENS = 32
HF_TINY_LAYERS = 4
HF_LLAMA = "llama-3.1-8b"
HF_LLAMA_TOKENS = 16
# Decode dispatches before the long chat enters the queue: the same step
# on every engine, so two engines on the same weights batch alike.
HF_INJECT_AT = 2
# The synthetic tokenizers' merges are learned from the phase's prompts.
HF_CORPUS = SHORT + [HIT, LONG, "You answer in one short paragraph."]
HF_SYSTEM = {"role": "system", "content": HF_CORPUS[-1]}


class _DeltaLog:
    """Tokenizer proxy: each stream's decoder appends (id, text delta) to
    the list its task set in ``_STREAM_IDS``."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, log = self._tok.stream_decoder(), _STREAM_IDS.get()

        class _Dec:
            def feed(self, token_id):
                text = dec.feed(token_id)
                if log is not None:
                    log.append((int(token_id), text))
                return text

        return _Dec()


class _RssPeak:
    """The host's resident set sampled every 5 ms on a thread while
    entered: ``before`` and ``peak`` bytes."""

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self._rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self._rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


async def _serve_chats(engine, prompts: dict, long_name: str | None,
                       tokens: int) -> dict:
    """Greedy streams of ``prompts`` (name -> prompt text): all but
    ``long_name`` sent at once (the loop is idle, so it admits them in one
    pass), ``long_name`` put in the queue at the scheduler's
    ``HF_INJECT_AT``-th dispatch, while the others decode.  name -> its
    token ids, the concatenated text deltas, and its final chunk's
    counts."""
    sched = engine.scheduler
    out: dict = {}

    async def run(name: str) -> None:
        log: list = []
        _STREAM_IDS.set(log)
        final = None
        async for chunk in engine.generate(prompts[name], max_tokens=tokens):
            final = chunk
        out[name] = {"ids": [t for t, _ in log],
                     "deltas": "".join(d for _, d in log),
                     "done": final.done,
                     "completion_tokens": final.completion_tokens,
                     "prompt_tokens": final.prompt_tokens}

    admit, late = sched._admit_pending, []

    async def admit_then_inject() -> None:
        if (long_name and not late
                and sched.host_dispatches >= HF_INJECT_AT):
            n = sched.pending.qsize()
            late.append(asyncio.create_task(run(long_name)))
            while sched.pending.qsize() == n and not late[0].done():
                await asyncio.sleep(0)
        await admit()

    sched._admit_pending = admit_then_inject
    try:
        await asyncio.gather(*[asyncio.create_task(run(n)) for n in prompts
                               if n != long_name])
        if long_name and not late:
            raise AssertionError("hf: the long chat was never sent")
        await asyncio.gather(*late)
    finally:
        del sched._admit_pending
    return out


def _hf_model(dev, root: str, name: str, registry: str, params: dict,
              config: dict, tokenizer: tuple, shards: int, chats: dict,
              long_name: str, tokens: int, layers: int | None) -> dict:
    """One HF directory written and served (see :func:`hf_phase`)."""
    import os

    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import save_hf_checkpoint
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.models.convert import hf_state_dict
    from crowdllama_tpu_torch.testing.hf_fixtures import write_tokenizer

    want_cfg = get_config(registry, **({"num_layers": layers} if layers
                                       else {}))
    path = os.path.join(root, name)
    t0 = time.perf_counter()
    if layers:
        config = dict(config, num_hidden_layers=layers)
    files = save_hf_checkpoint(hf_state_dict(want_cfg, params), config,
                               path, shards=shards)
    write_tokenizer(path, *tokenizer)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(f) for f in files)
    gc.collect()

    async def serve_hf():
        torch.cuda.reset_peak_memory_stats(dev)
        engine = TorchEngine(device=dev, model=name, model_path=path)
        t0 = time.perf_counter()
        with _RssPeak() as rss:
            await engine.start()
        start_s = time.perf_counter() - t0
        try:
            # Every loaded tensor as written (on the card, as the runner
            # holds it), and the config as the registry's.
            flat_loaded = _flat(engine.runner.params[0])
            flat_want = _flat(params)
            unequal = sorted(k for k in flat_want
                             if k not in flat_loaded or not torch.equal(
                                 flat_loaded[k], flat_want[k].to(dev)))
            clamp = min(want_cfg.max_context_length,
                        engine.config.max_context_length)
            cfg_want = dataclasses.replace(want_cfg, name=name,
                                           max_context_length=clamp)
            prompts = {n: engine._format_chat(m) for n, m in chats.items()}
            tok = engine.tokenizer
            engine.tokenizer = _DeltaLog(tok)
            hits0 = engine.runner.prefix_hits
            _zero_launches()
            served = await _serve_chats(engine, prompts, long_name, tokens)
            launches = _launches()
            hits = engine.runner.prefix_hits - hits0
            ragged = engine.scheduler.ragged_chunks
            ragged_chunk = engine.runner.ragged_chunk
        finally:
            await engine.stop()
        return {"engine": engine, "tok": tok, "prompts": prompts,
                "served": served, "launches": launches, "hits": hits,
                "ragged_chunks": ragged, "ragged_chunk": ragged_chunk,
                "start_s": start_s, "rss": rss, "unequal": unequal,
                "n_tensors": len(flat_want), "cfg_ok":
                engine.model_config == cfg_want,
                "cfg": dataclasses.asdict(engine.model_config)}

    got = asyncio.run(serve_hf())
    engine, tok = got.pop("engine"), got["tok"]
    load_s = engine.load_seconds
    del engine
    _free_card()

    async def serve_memory():
        # The same weights in memory, fed the same prompt ids (the HF
        # engine's tokenizer), the same steps.
        engine = TorchEngine(params=params, device=dev, model=registry,
                             model_config=want_cfg if layers else None)
        await engine.start()
        engine.tokenizer = _DeltaLog(tok)
        try:
            return await _serve_chats(engine, got["prompts"], long_name,
                                      tokens)
        finally:
            await engine.stop()

    ref = asyncio.run(serve_memory())
    _free_card()
    served = got["served"]
    streams = {}
    for n, v in served.items():
        streams[n] = {
            "prompt_tokens": v["prompt_tokens"],
            "done": v["done"] and v["completion_tokens"] == tokens
            and len(v["ids"]) == tokens,
            "same_as_memory": v["ids"] == ref[n]["ids"],
            "deltas_equal_decode": v["deltas"] == tok.decode(v["ids"])}
    line = {"layers": want_cfg.num_layers,
            "head_dim": want_cfg.resolved_head_dim(),
            "config_equal": got["cfg_ok"], "rope_scaling":
            got["cfg"]["rope_scaling"], "shards": len(files),
            "bytes": nbytes, "write_s": write_s, "load_s": load_s,
            "load_gb_per_s": nbytes / load_s / 1e9, "start_s":
            got["start_s"], "rss_before_bytes": got["rss"].before,
            "rss_peak_bytes": got["rss"].peak,
            "tensors_equal": not got["unequal"],
            "tensors": got["n_tensors"], "launches": got["launches"],
            "prefix_hits": got["hits"],
            "ragged_chunks": got["ragged_chunks"], "streams": streams,
            "bos_id": tok.bos_id, "eos_id": tok.eos_id}
    long_tokens = served[long_name]["prompt_tokens"]
    if not (got["cfg_ok"] and not got["unequal"]
            and all(v["done"] and v["same_as_memory"]
                    and v["deltas_equal_decode"] for v in streams.values())
            and all(got["launches"][k] > 0 for k in ("A", "B", "C"))
            and long_tokens > got["ragged_chunk"]
            and got["ragged_chunks"] >= 1):
        raise AssertionError(f"hf {name}: {line} (config "
                             f"{got['cfg']}, unequal {got['unequal'][:5]})")
    return line


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _zero_columns(params: dict, ids) -> dict:
    """Zero the unembedding columns of ``ids`` in place: random weights
    then never emit them (the model's EOS, and the byte tokens whose lone
    decodes a stream decoder renders differently from a whole decode)."""
    params["lm_head"][:, torch.as_tensor(list(ids))] = 0
    return params


def hf_phase(dev, keep: str) -> dict:
    """HF checkpoints served through ``TorchEngine(model=<a name outside
    the registry>, model_path=dir)``.  Two directories are written under
    a temporary directory by the port's own ``save_hf_checkpoint`` /
    ``write_safetensors``: bf16 tensors under ``LlamaForCausalLM`` names,
    projections ``[out, in]``, in two shards with a
    ``model.safetensors.index.json``; the published ``config.json``
    fields; a ``tokenizer.json`` and a ``tokenizer_config.json`` with the
    family's chat template, written here (``testing/hf_fixtures.py``):

    - tinyllama-1.1b at full width cut to ``HF_TINY_LAYERS`` layers
      (``reduced``; the share phase pulls this directory twice, and at
      full depth its 2.2 GB took ~90 s of AEAD-bound transfer): the
      seed-0 weights with the unembedding of ``<unk>``, ``<s>``, ``</s>``
      and the 256 byte tokens zeroed; TinyLlama's kind of byte-fallback BPE; TinyLlama-Chat's
      template; the paged phase's 8 streams of 32 tokens as chats (6
      short, the prefix hit, the long one sent while the others decode);
    - llama-3.1-8b cut to ``LLAMA_CUT_LAYERS`` layers (``reduced``), its
      llama3 rope scaling in config.json: random weights from seed 0 with
      the byte tokens' and the specials' columns zeroed; Llama-3's kind of
      byte-level BPE; Llama-3.1's template; 2 short chats and the long
      one of 16 tokens.

    Each must: derive the registry's config (but the name and the cut),
    hold every tensor as written, stream token for token what an engine
    given the same weights in memory streams from the same prompt ids in
    the same steps, launch kernels A, B and C (counts zeroed right before
    the streams: Dh 64, then Dh 128), and stream deltas that concatenate
    to ``decode`` of the ids.  The line: per model the write and load
    seconds, GB/s of the load (from the page cache), the host's RSS
    before and at its peak while the engine started, shards and bytes,
    the launches and each chat's prompt tokens.  The tinyllama directory
    is written under ``keep`` and outlives the phase (the share phase
    serves it)."""
    import tempfile

    from crowdllama_tpu_torch.engine.weights import init_params
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.testing import hf_fixtures as hf

    chats = {f"short{i}": [{"role": "user", "content": p}]
             for i, p in enumerate(SHORT)}
    chats["short5"] = [HF_SYSTEM, {"role": "user", "content": SHORT[5]}]
    chats["prefix_hit"] = [{"role": "user", "content": HIT}]
    chats["long"] = [{"role": "user", "content": LONG}]
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hf") as root:
        # A fresh copy: the cached one is shared, and its columns are
        # zeroed here in place.
        params = _cut(_zero_columns(seed0_params.__wrapped__(dev),
                                    range(3 + 256)), HF_TINY_LAYERS)
        out[TINYLLAMA] = _hf_model(
            dev, keep, SHARE_NAME, TINYLLAMA, params,
            hf.TINYLLAMA_CONFIG, hf.sentencepiece_tokenizer(HF_CORPUS), 2,
            chats, "long", HF_TOKENS, HF_TINY_LAYERS)
        out[TINYLLAMA]["reduced"] = {"num_layers": [22, HF_TINY_LAYERS]}
        del params
        _free_card()
        cfg = get_config(HF_LLAMA, num_layers=LLAMA_CUT_LAYERS)
        params = init_params(cfg, seed=0, device=dev)
        _zero_columns(params, [*range(256), *range(128000, 128256)])
        params = {k: ({x: y.cpu() for x, y in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
        _free_card()
        out[HF_LLAMA] = _hf_model(
            dev, root, "hf-llama-3.1-instruct", HF_LLAMA, params,
            hf.LLAMA31_CONFIG, hf.byte_level_tokenizer(HF_CORPUS), 2,
            {k: [HF_SYSTEM, *chats[k]] if k == "short1" else chats[k]
             for k in ("short0", "short1", "long")}, "long",
            HF_LLAMA_TOKENS, LLAMA_CUT_LAYERS)
        out[HF_LLAMA]["reduced"] = {"num_layers": [32, LLAMA_CUT_LAYERS]}
        del params
    _free_card()
    return {"phase": "hf", **out, "seconds": time.perf_counter() - t0,
            "card": torch.cuda.get_device_name(0),
            "nvidia_smi": nvidia_smi()}


# ------------------------------------------------------------ megastep

MEGASTEP_K = 8
MEGASTEP_PAIRS = 5
MEGASTEP_SUB_TOKENS = 16


class _StepCount:
    """Instruments a runner's dispatch entry points (on the instance): the
    steps and calls of each, so a phase can hold the launch counts
    against the steps the scheduler dispatched."""

    ENTRIES = {"decode_steps_device": 1, "decode_megastep": 1,
               "ragged_step": 2, "ragged_megastep": 2}

    def __init__(self, r):
        self.steps = dict.fromkeys(self.ENTRIES, 0)
        self.calls = dict.fromkeys(self.ENTRIES, 0)
        for name, pos in self.ENTRIES.items():
            fn = getattr(r, name, None)
            if fn is not None:
                setattr(r, name, self._wrap(name, pos, fn))

    def _wrap(self, name, pos, fn):
        def counted(*a, **kw):
            self.steps[name] += kw.get("num_steps",
                                       a[pos] if len(a) > pos else 1)
            self.calls[name] += 1
            return fn(*a, **kw)
        return counted

    def reset(self) -> None:
        for d in (self.steps, self.calls):
            for k in d:
                d[k] = 0

    def decode_steps(self) -> int:
        return self.steps["decode_steps_device"] + self.steps[
            "decode_megastep"]

    def ragged_steps(self) -> int:
        return self.steps["ragged_step"] + self.steps["ragged_megastep"]


async def _serve_ids(engine, streams: dict, max_tokens: int) -> dict:
    """Send ``streams`` (name -> (prompt, kwargs)) at once; each stream's
    token ids, every stream checked done with ``max_tokens`` tokens."""
    out: dict[str, list] = {}

    async def run(name, prompt, kw):
        ids: list[int] = []
        _STREAM_IDS.set(ids)
        final = None
        async for chunk in engine.generate(prompt, max_tokens=max_tokens,
                                           **kw):
            final = chunk
        if not (final.done and final.completion_tokens == max_tokens
                and len(ids) == max_tokens):
            raise AssertionError(f"megastep: stream {name} ended {final}")
        out[name] = ids

    await asyncio.gather(*(run(n, p, kw) for n, (p, kw) in streams.items()))
    return out


def _clone_state(st):
    """A copy of a decode state: every tensor cloned, the host keys too."""
    import dataclasses

    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, list):
            return [t.clone() for t in v]
        return v.copy() if hasattr(v, "copy") else v

    return dataclasses.replace(st, **{f.name: copy(getattr(st, f.name))
                                      for f in dataclasses.fields(st)})


def _live_state(r, tok, temperature: float = 0.0):
    st = r.init_state()
    for slot in range(r.max_slots):
        ids = tok.encode(SHORT[slot % len(SHORT)] + str(slot))
        first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None)
        st = r.insert(st, slot, ks, vs, plen, first, temperature, 1.0,
                      prompt_tokens=ids)
    return st


def megastep_flight_check(r, tok) -> dict:
    """One K-step flight with 8 live slots as a graph replay and eagerly
    (``decode_steps_device`` on a copy of the state): the tokens agree up
    to the whole-batch exit, the rows after it are zero, and the
    done-flags fire where ``_emit`` retires each slot (its budget, slot
    0's EOS id taken from the eager tokens)."""
    import numpy as np

    k = MEGASTEP_K
    with torch.inference_mode():
        st = _live_state(r, tok)
        copy = _clone_state(st)
        eager, _ = r.decode_steps_device(copy, k)
        eager = eager.cpu().numpy()
        budgets = np.array([3, 5, 6, 2, 6, 4, 1, 5], np.int32)[:r.max_slots]
        eos = np.full((r.max_slots,), -1, np.int32)
        eos[0] = eager[1, 0]
        replays = sum(g.replays for g in r._graphs._graphs.values())
        toks, done, _ = r.decode_megastep(st, k, eos_ids=eos,
                                          budgets=budgets)
        toks, done = toks.cpu().numpy(), done.cpu().numpy()
        if sum(g.replays for g in r._graphs._graphs.values()) != replays + 1:
            raise AssertionError("megastep: the flight did not replay a graph")
    fire = []
    for s in range(r.max_slots):
        hits = [i for i in range(k)
                if eager[i, s] == eos[s] or i + 1 >= budgets[s]]
        fire.append(hits[0])
    want = np.zeros_like(done)
    for s, i in enumerate(fire):
        want[i, s] = True
    last = max(fire)
    if not ((toks[:last + 1] == eager[:last + 1]).all()
            and not toks[last + 1:].any() and (done == want).all()):
        raise AssertionError(f"megastep: graph flight {toks.tolist()} "
                             f"{done.astype(int).tolist()} vs eager "
                             f"{eager.tolist()}, fires {fire}")
    return {"steps": k, "fires": fire, "rows_compared": last + 1}


def megastep_timing(r, tok) -> dict:
    """Host ms per step, alternated in pairs on one state with 8 live
    slots: a K-step graph replay and eager ``decode_steps_device(K)``,
    each ending in a synchronize; then captures on fresh graph caches
    (the masked warm-up, the capture and the first replay, the capture
    alone, the graph pool's reserved bytes)."""
    from crowdllama_tpu_torch.engine.graphs import GraphCache

    k = MEGASTEP_K
    graph_ms, eager_ms, caps = [], [], []
    with torch.inference_mode():
        st = _live_state(r, tok)
        r.decode_megastep(st, k)
        r.decode_steps_device(st, k)
        for _ in range(MEGASTEP_PAIRS):
            for fn, out in ((r.decode_megastep, graph_ms),
                            (r.decode_steps_device, eager_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(st, k)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3 / k)
        kept = r._graphs
        try:
            for _ in range(MEGASTEP_PAIRS):
                r._graphs = cache = GraphCache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.decode_megastep(st, k)
                torch.cuda.synchronize()
                caps.append({"first_flight_s": time.perf_counter() - t0,
                             "capture_s": cache.capture_s[0],
                             "pool_bytes": cache.pool_bytes[0]})
        finally:
            r._graphs = kept
    return {"k": k, "slots": r.max_slots, "graph_ms_per_step": graph_ms,
            "eager_ms_per_step": eager_ms, "captures": caps}


def megastep_top_ops(r, tok, n: int = 8) -> dict:
    """``torch.profiler`` in this thread around one K-step graph flight
    and one eager K-step chunk on a state of 8 live slots: each one's
    device us per step and its top ``n`` kernels by device time (with
    their calls), and the top ``n`` operators by the device time of the
    kernels they launched.  Runs after every graph capture of the phase
    (a profiler session starts the device tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    k = MEGASTEP_K
    out = {}
    with torch.inference_mode():
        st = _live_state(r, tok)
        for name, fn in (("graph", r.decode_megastep),
                         ("eager", r.decode_steps_device)):
            fn(st, k)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                fn(st, k)
                torch.cuda.synchronize()
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type.name == "CUDA"]
            ops = [e for e in events if e.device_type.name == "CPU"
                   and e.key.startswith("aten::")]
            out[name] = {
                "kernels": sum(e.count for e in kernels),
                "device_us_per_step": sum(e.self_device_time_total
                                          for e in kernels) / k,
                "top_kernels": [
                    {"name": e.key[:120], "device_us": e.self_device_time_total,
                     "calls": e.count}
                    for e in sorted(kernels, key=lambda e:
                                    -e.self_device_time_total)[:n]],
                "top_ops": [
                    {"name": e.key, "device_us": e.device_time_total,
                     "calls": e.count}
                    for e in sorted(ops, key=lambda e:
                                    -e.device_time_total)[:n]]}
    return out


def _expect_steps(launches: dict, kernel: str, per_step: int, steps: int,
                  phase: str) -> None:
    if launches[kernel] != per_step * steps or steps <= 0:
        raise AssertionError(f"{phase}: {kernel} launched "
                             f"{launches[kernel]} times, not {per_step} per "
                             f"step of {steps} steps: {launches}")


def megastep_sub_phase(dev, phase: str, ran: set, decode_kernel: str,
                       params=None, model: str = TINYLLAMA, **engine_kw):
    """One more path under megastep: 2 greedy prompts of 16 tokens served
    eagerly (the scheduler's megastep off), then again under megastep, on
    one engine without the prefix cache (so both passes prefill the same
    way): token-identical; under megastep only the kernels in ``ran``
    launch, ``decode_kernel`` once a layer a decode step, and graph
    replays ran."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    if "devices" not in engine_kw:
        engine_kw["device"] = dev
    streams = {k: GREEDY[k] for k in ("short0", "short2")}

    async def go():
        engine = TorchEngine(params=seed0_params(dev) if params is None
                             else params, model=model,
                             megastep_k=MEGASTEP_K, decode_chunk=8,
                             kv_prefix_cache=False, **engine_kw)
        await engine.start()
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        r = engine.runner
        count = _StepCount(r)
        try:
            engine.scheduler._megastep = False
            eager = await _serve_ids(engine, streams, MEGASTEP_SUB_TOKENS)
            engine.scheduler._megastep = True
            replays0 = sum(g.replays for g in r._graphs._graphs.values())
            _zero_launches()
            count.reset()
            mega = await _serve_ids(engine, streams, MEGASTEP_SUB_TOKENS)
            launches = _launches()
            replays = sum(g.replays for g in r._graphs._graphs.values()) \
                - replays0
        finally:
            await engine.stop()
        return engine, eager, mega, launches, dict(count.steps), replays

    engine, eager, mega, launches, steps, replays = asyncio.run(go())
    r = engine.runner
    layers = r.cfg.num_layers
    if mega != eager:
        raise AssertionError(f"{phase}: megastep streams {mega} differ from "
                             f"eager {eager}")
    _expect_launches(launches, ran, phase)
    decode_steps = steps["decode_steps_device"] + steps["decode_megastep"]
    _expect_steps(launches, decode_kernel, layers, decode_steps, phase)
    if launches["A"] % (layers * r.tp) or not replays \
            or steps["decode_megastep"] < MEGASTEP_K:
        raise AssertionError(f"{phase}: A {launches['A']}, {replays} graph "
                             f"replays, steps {steps}")
    out = {"phase": phase, "model": model, "layers": layers,
           "head_dim": r.cfg.resolved_head_dim(), "tp": r.tp,
           "kv_layout": r.kv_layout, "kv_dtype": r.kv_dtype,
           "megastep_k": MEGASTEP_K, "streams": len(streams),
           "tokens": MEGASTEP_SUB_TOKENS, "launches": launches,
           "steps": steps, "graph_replays": replays,
           "graph_captures": r._graphs.captures,
           "capture_s": r._graphs.capture_s,
           "pool_bytes": r._graphs.pool_bytes,
           "token_identical_to_eager": True}
    if model == LLAMA:
        out["reduced"] = {"num_layers": [32, layers]}
    return out


def megastep_phase(dev, paged: dict) -> tuple[dict, dict]:
    """TorchEngine with ``megastep_k=8`` (tinyllama-1.1b at full width and
    depth, paged bf16, TinyLlama's seed-0 weights, decode_chunk 8).

    The paged phase's streams (6 greedy short prompts, the prefix hit, the
    seeded stream and the 1,465-token prompt, which waits for the first
    free slot and prefills beside the others' decode), all sent at once,
    so the scheduler's sequence of dispatches is the same whatever the
    host's speed: once with the scheduler's megastep off, then, after
    ``init_state`` (the scheduler's state, zeroed in place: an empty pool
    and prefix cache), under megastep, token-identical; the seeded stream
    sent again alone repeats.  (Held against the eager paged phase's
    streams only as a share: there the long prompt arrives on a host-timed
    poll, and which decode steps ride the ragged flights, whose decode
    rows kernel C sums in another order than B, moves with the host's
    speed.)  Under megastep the graphs captured at warm-up serve every
    flight; B launches 22 times a decode step and C 22 times a ragged
    step, ragged_mega flights among them, A in multiples of 22, no other
    kernel; the gauges (duty cycle of the megastep and ragged_mega classes
    nonzero, not wedged, host gaps counted).  Then on the runner, the
    scheduler idle: one flight graph against eager, host ms per step in
    alternated pairs, capture times and pool bytes.  Then the card's busy
    share over 1 s while 4 streams decode under megastep, from CUDA
    events around every graph replay in the window (the profiler's trace
    holds no kernel of a graph replayed from the dispatch thread), and
    last the top device kernels and operators of one graph flight and one
    eager chunk (``megastep_top_ops``).  The sub-phases come first: paged
    int8 (B-int8), contiguous (D), tp=2 on the card (F) and llama-3-8b
    cut to 4 layers (Dh 128).  Every capture of the phase precedes its
    profiler session.  Returns (the phase's line, the profile line) for
    the caller to print."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.obs.metrics import ENGINE_TELEMETRY

    subs = []
    for phase, ran, kernel, kw in (
            ("megastep_int8", {"A", "B_int8"}, "B_int8",
             dict(kv_dtype="int8")),
            ("megastep_contiguous", {"A", "D"}, "D",
             dict(kv_layout="contiguous")),
            ("megastep_tp", {"A", "F"}, "F",
             dict(mesh_shape="2", devices=[dev, dev]))):
        subs.append(megastep_sub_phase(dev, phase, ran, kernel, **kw))
        _free_card()
    cfg, params = llama_params(dev, LLAMA_CUT_LAYERS)
    subs.append(megastep_sub_phase(dev, "megastep_llama", {"A", "B"}, "B",
                                   params=params, model=LLAMA,
                                   model_config=cfg))
    del params
    _free_card()

    streams = {**GREEDY, "prefix_hit": (HIT, {}), "sampled": SAMPLED,
               "long": (LONG, {})}
    classes = ("plain", "megastep", "ragged", "other")

    async def go() -> dict:
        engine = TorchEngine(params=seed0_params(dev), device=dev,
                             model=TINYLLAMA, megastep_k=MEGASTEP_K,
                             decode_chunk=8)
        t0 = time.perf_counter()
        await engine.start()
        out: dict = {"start_s": time.perf_counter() - t0}
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        r, sched = engine.runner, engine.scheduler
        graphs = r._graphs
        out["warmup_graphs"] = {"captures": graphs.captures,
                                "capture_s": list(graphs.capture_s),
                                "pool_bytes": list(graphs.pool_bytes)}
        count = _StepCount(r)
        try:
            sched._megastep = False
            out["eager"] = await _serve_ids(engine, streams, 32)
            if r.init_state() is not sched.state:
                raise AssertionError("megastep: init_state did not keep the "
                                     "captured state")
            sched._megastep = True
            gaps0 = {c: ENGINE_TELEMETRY.host_gap_seconds.labels(c).count
                     for c in classes}
            _zero_launches()
            count.reset()
            t1 = time.perf_counter()
            out["mega"] = await _serve_ids(engine, streams, 32)
            out["wall_s"] = time.perf_counter() - t1
            out["launches"] = _launches()
            out["steps"], out["calls"] = dict(count.steps), dict(count.calls)
            out["captures_while_serving"] = graphs.captures - 2
            out["sampled_again"] = (await _serve_ids(
                engine, {"sampled": SAMPLED}, 32))["sampled"]
            out["gauges"] = engine.obs_gauges()
            out["host_gap_counts"] = {
                c: ENGINE_TELEMETRY.host_gap_seconds.labels(c).count
                - gaps0[c] for c in classes}
            out["flight"] = megastep_flight_check(r, engine.tokenizer)
            out["timing"] = megastep_timing(r, engine.tokenizer)
            r.init_state()

            logs = [[] for _ in range(4)]

            async def drive(i, prompt):
                _STREAM_IDS.set(logs[i])
                async for _ in engine.generate(prompt, max_tokens=1024):
                    pass

            tasks = [asyncio.create_task(drive(i, p))
                     for i, p in enumerate(SHORT[:4])]
            while min(len(x) for x in logs) < 2:
                await asyncio.sleep(0.01)
            # CUDA events around every graph replay of a 1 s window: the
            # device span of each flight (the profiler's trace shows no
            # kernel of a graph replayed from the dispatch thread).
            spans: list = []
            replays = {g: g._replay for g in graphs._graphs.values()}
            for g, fn in replays.items():
                g._replay = _event_timed(fn, spans)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            await asyncio.sleep(PROFILE_S)
            ev1.record()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for g, fn in replays.items():
                g._replay = fn
            torch.cuda.synchronize(dev)
            inside = [(a, b) for a, b in spans
                      if ev0.elapsed_time(a) >= 0 and b.elapsed_time(ev1) >= 0]
            if not inside:
                raise AssertionError("megastep: no graph replay in the "
                                     "busy-share window")
            window_ms = ev0.elapsed_time(ev1)
            replay_ms = sum(a.elapsed_time(b) for a, b in inside)
            out["busy"] = {"streams": 4, "replays": len(inside),
                           "replay_device_ms": replay_ms,
                           "window_ms": window_ms,
                           "busy_share": replay_ms / window_ms}
            while any(s is not None for s in sched.slots):
                await asyncio.sleep(0.01)
            out["top_ops"] = megastep_top_ops(r, engine.tokenizer)
            r.init_state()
        finally:
            await engine.stop()
        return out

    out = asyncio.run(go())
    _free_card()
    eager, mega = out.pop("eager"), out.pop("mega")
    same = {n: mega[n] == ids for n, ids in eager.items()}
    if not all(same.values()):
        raise AssertionError(f"megastep: streams differ from the eager "
                             f"pass's: {same}")
    if out["sampled_again"] != mega["sampled"]:
        raise AssertionError(f"megastep: the seeded stream did not repeat: "
                             f"{mega['sampled']} vs {out['sampled_again']}")
    shared = [a == b for n, ids in paged["ids"].items() if n in mega
              for a, b in zip(ids, mega[n])]
    launches, steps, calls = out["launches"], out["steps"], out["calls"]
    _expect_launches(launches, {"A", "B", "C"}, "megastep")
    decode_steps = steps["decode_steps_device"] + steps["decode_megastep"]
    ragged_steps = steps["ragged_step"] + steps["ragged_megastep"]
    _expect_steps(launches, "B", 22, decode_steps, "megastep")
    _expect_steps(launches, "C", 22, ragged_steps, "megastep")
    if launches["A"] % 22 or not calls["ragged_megastep"] \
            or not calls["decode_megastep"] or out["captures_while_serving"]:
        raise AssertionError(f"megastep: A {launches['A']}, calls {calls}, "
                             f"{out['captures_while_serving']} captures "
                             f"while serving")
    g = out["gauges"]
    if not (g["duty_cycle|dispatch=megastep"] > 0
            and g["duty_cycle|dispatch=ragged_mega"] > 0
            and g["wedged"] == 0 and out["host_gap_counts"]["megastep"] > 0):
        raise AssertionError(f"megastep: gauges {g}, host gaps "
                             f"{out['host_gap_counts']}")
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    profile_line = {"phase": "megastep_profile", "model": TINYLLAMA,
                    "megastep_k": MEGASTEP_K, **out.pop("top_ops"),
                    "card": card, "nvidia_smi": smi}
    line = {"phase": "megastep", "model": TINYLLAMA, "layers": 22,
            "megastep_k": MEGASTEP_K, "decode_chunk": 8, **out,
            "decode_steps": decode_steps, "ragged_steps": ragged_steps,
            "streams_identical_to_eager_pass": same,
            "tokens_equal_to_paged_phase": sum(shared) / len(shared),
            "sampled_ids": mega["sampled"], "sub_phases": subs, "card": card, "nvidia_smi": smi}
    return line, profile_line


# ------------------------------------------------------------- speculation

SPEC_TOKENS = 64
SPEC_DRAFT = 4
# The permutation weights' depth in the spec phase (``reduced``): their
# layers add nothing to the logits, so the streams and acceptance are the
# full model's; the eager steps' host time scales with the layers, and
# the cut keeps the script inside its limit.
SPEC_LAYERS = 4
SPEC_PAIRS = 5
# Echo prompts: a stretch of the permutation cycle over printable ASCII
# (one byte token a character, which the byte tokenizer round-trips),
# then the stretch's first ids again, so the greedy walk replays the
# stretch for all SPEC_TOKENS tokens: (first id, stretch, repeat).
ECHO_RUNS = ((32, 92, 4), (33, 90, 5), (34, 88, 6), (35, 85, 3))
ECHO = {f"echo{i}": ("".join(map(chr, range(a, a + n)))
                     + "".join(map(chr, range(a, a + m))), {})
        for i, (a, n, m) in enumerate(ECHO_RUNS)}
NON_ECHO = {f"short{i}": (SHORT[i], {}) for i in (2, 3, 5)}
SPEC_STREAMS = {**ECHO, **NON_ECHO}


@functools.cache
def perm_params(dev) -> dict:
    """TinyLlama-1.1B's width and depth with the permutation weights
    (``testing/modelgen.py``) in bf16 on the card: greedy decode walks the
    next-id cycle with O(1) logit margins, so every path emits the same
    tokens."""
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.testing.modelgen import permutation_params

    return permutation_params(get_config(TINYLLAMA), dtype=torch.bfloat16,
                              device=dev)


def _cut(params: dict, layers: int) -> dict:
    return {**params, "layers": {k: v[:layers].clone()
                                 for k, v in params["layers"].items()}}


def _tiny_config(params: dict):
    """TinyLlama's config at the depth of ``params``."""
    from crowdllama_tpu_torch.models.config import get_config

    return get_config(TINYLLAMA, num_layers=params["layers"]["wq"].shape[0])


def _spec_recorders(engine) -> tuple[dict, list]:
    """Per request (by stream name, from its prompt): tokens emitted in
    speculative flights, the verify steps they took, and the drafts
    offered and accepted in them; and the runner's draft lengths as the
    controller sets them."""
    from crowdllama_tpu_torch.engine.scheduler import _SlotInfo

    sched, runner = engine.scheduler, engine.runner
    names = {p: n for n, (p, _) in {**SPEC_STREAMS, "long": (LONG, {})}
             .items()}
    tok = engine.tokenizer
    by_ids = {tuple(tok.encode(p)): n for p, n in names.items()}
    per: dict = {}
    emit_flight = sched._emit_flight

    def recorded(fl, tokens):
        before = {i: info.generated for i, info in enumerate(fl.snapshot)
                  if isinstance(info, _SlotInfo)}
        out = emit_flight(fl, tokens)
        if tokens.ndim != 3:
            return out
        k = tokens.shape[1] - 3
        for i, g0 in before.items():
            info = fl.snapshot[i]
            got = info.generated - g0
            steps = cum = 0
            for s in range(tokens.shape[0]):
                if cum >= got:
                    break
                steps += 1
                cum += int(tokens[s, 0, i])
            name = by_ids.get(tuple(info.req.prompt_ids), "other")
            d = per.setdefault(name, {"emitted": 0, "steps": 0,
                                      "accepted": 0, "offered": 0})
            d["emitted"] += got
            d["steps"] += steps
            d["accepted"] += got - steps
            d["offered"] += steps * k
        return out

    sched._emit_flight = recorded
    ks = [getattr(runner, "draft_len", 0)]
    set_k = getattr(runner, "set_draft_len", None)
    if set_k is not None:
        def record_k(k):
            set_k(k)
            ks.append(runner.draft_len)

        runner.set_draft_len = record_k
    return per, ks


def _expect_spec_launches(phase: str, launches: dict, ran: set, held: str,
                          layers: int, classes: dict) -> None:
    """Kernels in ``ran`` launched, ``held`` exactly ``layers`` times per
    step of the ``plain`` dispatch class (``classes``: steps per class,
    from the scheduler's flight plane), and no other kernel."""
    want_held = layers * classes.get("plain", 0)
    for k, n in launches.items():
        ok = (n > 0 if k in ran else n == 0)
        if k == held:
            ok = n == want_held and (n > 0 or k not in ran)
        if not ok:
            raise AssertionError(
                f"{phase}: kernel {k} launched {n} times (ran {sorted(ran)}, "
                f"{held} held to {layers} x {classes.get('plain', 0)} plain "
                f"steps): {launches}, classes {classes}")


def spec_engine(dev, params, phase: str, ref: dict | None, ran: set,
                held: str, probe_interval: int = 0, streams=None,
                long: bool = True, **engine_kw) -> dict:
    """One engine on ``params`` serving ``streams`` (default: the echo and
    short prompts, then LONG while they decode, unless ``long`` is False)
    with ``SPEC_TOKENS``
    tokens each, launch counts zeroed right before and read right after.
    Checks: every stream done and full; text and token ids equal to
    ``ref``'s (the plain engine's streams) when given; kernels in ``ran``
    launched and ``held`` (the layout's plain decode kernel) launched
    exactly ``num_layers`` times per step of the ``plain`` dispatch class;
    no other kernel launched.  Then, on a speculative engine, the seeded
    sampled stream twice, alone: it must repeat."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    streams = SPEC_STREAMS if streams is None else streams

    async def go():
        torch.cuda.synchronize(dev)
        engine = TorchEngine(params=params, device=dev, model=TINYLLAMA,
                             model_config=_tiny_config(params), **engine_kw)
        await engine.start()
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        sched = engine.scheduler
        if probe_interval:
            sched.spec_probe_interval = probe_interval
        per, ks = _spec_recorders(engine)
        try:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_launches()
            served = await serve(engine, streams, SPEC_TOKENS, long=long)
            launches = _launches()
            classes = dict(sched.class_steps)
            # What the sampled stream below moves is not this traffic's.
            ctl = dict(retunes=sched.spec_retunes, probes=sched.spec_probes,
                       stats=engine.describe().get("spec_decode", {}),
                       draft_len_trajectory=list(ks))
            del sched._emit_flight
            peak = torch.cuda.max_memory_allocated(dev)
            gauges = engine.obs_gauges()
            sampled = None
            if engine_kw.get("spec_decode"):
                sampled = []
                for _ in range(2):
                    ids: list[int] = []
                    _STREAM_IDS.set(ids)
                    async for _c in engine.generate(
                            SAMPLED[0], max_tokens=SPEC_TOKENS,
                            **SAMPLED[1]):
                        pass
                    sampled.append(ids)
        finally:
            await engine.stop()
        return (engine, served, launches, classes, peak, gauges, per, ctl,
                sampled)

    engine, served, launches, classes, peak, gauges, per, ctl, sampled = \
        asyncio.run(go())
    reqs = served["requests"]
    for name, v in reqs.items():
        if not (v["done"] and len(v["ids"]) == SPEC_TOKENS):
            raise AssertionError(f"{phase}: stream {name} ended {v}")
        if ref is not None and (v["ids"] != ref[name]["ids"]
                                or v["text"] != ref[name]["text"]):
            raise AssertionError(f"{phase}: stream {name} differs from the "
                                 f"plain engine's: {v['ids']} vs "
                                 f"{ref[name]['ids']}")
    if sampled is not None and sampled[0] != sampled[1]:
        raise AssertionError(f"{phase}: the seeded sampled stream did not "
                             f"repeat: {sampled}")
    _expect_spec_launches(phase, launches, ran, held,
                          engine.runner.cfg.num_layers, classes)
    echo_tps = {n: d["emitted"] / max(1, d["steps"])
                for n, d in per.items() if n in ECHO}
    echo_walls = [reqs[n]["wall_s"] for n in ECHO if n in reqs]
    out = {"launches": launches, "class_steps": classes,
           "serve_peak": peak, "per_stream": per,
           "echo_tokens_per_verify_step": echo_tps,
           "echo_tokens_per_s": (SPEC_TOKENS * len(echo_walls)
                                 / max(echo_walls) if echo_walls else None),
           "tokens_per_s": (SPEC_TOKENS * len(reqs)) / served["wall_s"],
           "duty_cycle": {c: gauges[f"duty_cycle|dispatch={c}"]
                          for c in ("plain", "ragged", "spec")},
           "draft_len_trajectory": ctl["draft_len_trajectory"],
           "ids": {n: v["ids"] for n, v in reqs.items()},
           "requests": {n: {"text": v["text"], "wall_s": v["wall_s"],
                            "ttft_ms": v["ttft_ms"]}
                        for n, v in reqs.items()}}
    if engine_kw.get("spec_decode"):
        out.update(stats=ctl["stats"], retunes=ctl["retunes"],
                   probes=ctl["probes"],
                   tokens_per_verify_step=ctl["stats"].get("tokens_per_step"))
        if gauges["duty_cycle|dispatch=spec"] <= 0:
            raise AssertionError(f"{phase}: no spec duty cycle: {gauges}")
    return out


def spec_numerics(dev, params) -> dict:
    """On seed-0 random weights, per pool dtype (a speculative paged runner
    over 3 live slots): one verify step's row-0 logits (the plain
    ``prefill_attention_ctx`` over the gathered pages) against the plain
    decode step's logits through kernel B (or B-int8) on the same state,
    within ``LOGIT_RTOL`` of their scale.  Then, with all 8 slots live,
    host ms of one verify dispatch (k = 4) beside one plain step, in
    ``SPEC_PAIRS`` alternated pairs, and the context gather's ms (CUDA
    events around ``_verify_context``)."""
    from crowdllama_tpu_torch.engine.spec import SpecPagedModelRunner
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.models.config import get_config

    tok = ByteTokenizer()
    out = {}
    for kv in ("bf16", "int8"):
        r = SpecPagedModelRunner(get_config(TINYLLAMA), params=params,
                                 device=dev, kv_dtype=kv,
                                 draft_len=SPEC_DRAFT)
        held = "B" if kv == "bf16" else "B_int8"
        with torch.inference_mode():
            st = _three_slots(r, tok)
            r.pre_decode_check(1)
            table = r._table()
            drafts = torch.zeros((r.max_slots, SPEC_DRAFT), dtype=torch.int32,
                                 device=dev)
            verify = r.verify_forward(st, table, drafts)[0][:, 0]
            _zero_launches()
            plain = r.decode_logits(st, table)
            torch.cuda.synchronize()
            launched = _launches()
        _expect_spec_launches(f"spec numerics {kv}", launched, {held}, held,
                              r.cfg.num_layers, {"plain": 1})
        errs = _check_logit_errs(
            {"verify_row0_vs_decode": _logit_err(verify[:3], plain[:3])},
            f"spec {kv}")
        out[kv] = {**errs, **spec_dispatch_timing(r, tok)}
        del r, st, table, verify, plain
        _free_card()
    return out


def spec_dispatch_timing(r, tok) -> dict:
    with torch.inference_mode():
        st = r.init_state()
        for slot in range(r.max_slots):
            ids = tok.encode(SHORT[slot % len(SHORT)] + str(slot))
            first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None)
            st = r.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                          prompt_tokens=ids)

        def dispatch(k: int) -> float:
            r.set_draft_len(k)
            r.pre_decode_check(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.decode_steps(st, 1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        dispatch(0), dispatch(SPEC_DRAFT)  # warm
        pairs = []
        for i in range(SPEC_PAIRS):
            order = ((0, SPEC_DRAFT) if i % 2 == 0 else (SPEC_DRAFT, 0))
            row = {}
            for k in order:
                row["plain_ms" if k == 0 else "verify_ms"] = dispatch(k)
            pairs.append(row)
        spans: list = []
        r._verify_context = _event_timed(r._verify_context, spans)
        for _ in range(3):
            dispatch(SPEC_DRAFT)
        del r._verify_context
        torch.cuda.synchronize()
    return {"slots": r.max_slots, "draft_len": SPEC_DRAFT, "pairs": pairs,
            "verify_ms_mean": sum(p["verify_ms"] for p in pairs) / len(pairs),
            "plain_ms_mean": sum(p["plain_ms"] for p in pairs) / len(pairs),
            "gather_ms": sum(a.elapsed_time(b) for a, b in spans) / len(spans),
            "gather_bytes": 2 * r.cfg.num_layers * r.max_slots
            * r.max_pages_per_slot * r.page_size * r.cfg.num_kv_heads
            * r.cfg.resolved_head_dim() * 2}


def spec_pipeline(dev, params, ckpt: str) -> dict:
    """The gateway-drafted pipeline, every module the port's own, on
    127.0.0.1: a DHT node, a worker (``spec_decode="ngram"`` on the
    permutation weights), a consumer and its ``Gateway`` with
    ``spec_pipeline="gateway"`` drafting from the checkpoint on the card
    (its prefill kernel A, its step kernel D).  A streamed greedy
    ``/api/chat`` must equal a direct ``generate()`` of the chat prompt,
    with VerifyResults answered (``spec_pipeline_verifies``) and drafts
    accepted; then ``"worker"`` mode (pure ack credits): the same text."""
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import FakeEngine, TorchEngine
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    def key():
        return Ed25519PrivateKey.generate()

    prompt = ECHO["echo0"][0]

    async def go() -> dict:
        boot, _ = await new_host_and_dht(key(), listen_host="127.0.0.1")
        node = dict(listen_host="127.0.0.1",
                    bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
        engine = TorchEngine(params=params, device=dev, model=TINYLLAMA,
                             model_config=_tiny_config(params),
                             spec_decode="ngram", spec_draft=SPEC_DRAFT)
        worker = Peer(key(), Configuration(model=TINYLLAMA, **node), engine)
        consumer = Peer(key(), Configuration(**node), FakeEngine(models=[]),
                        worker_mode=False)
        gw = Gateway(consumer, port=0, host="127.0.0.1",
                     spec_pipeline="gateway", spec_draft_path=ckpt)
        started: list = []
        out: dict = {}
        try:
            for part in (engine, worker, consumer, gw):
                await part.start()
                started.append(part)
            await _wait_routable(consumer.peer_manager, {worker.peer_id})
            chat = engine._format_chat([{"role": "user", "content": prompt}])
            direct, _, _ = await _direct(engine, chat, SPEC_TOKENS)
            for mode in ("gateway", "worker"):
                gw.spec_pipeline = mode
                sched = engine.scheduler
                v0, st0 = sched.spec_verifies, dict(gw._spec_stats)
                _zero_launches()
                t0 = time.perf_counter()
                r = await asyncio.to_thread(
                    _http, gw.port, "POST", "/api/chat",
                    _chat_body(prompt, SPEC_TOKENS, True))
                wall = time.perf_counter() - t0
                launches = _launches()
                text = "".join(ln["message"]["content"] for ln in _ndjson(r))
                stats = {k: v - st0[k] for k, v in gw._spec_stats.items()}
                out[mode] = {"status": r["status"], "wall_s": wall,
                             "verifies": sched.spec_verifies - v0,
                             "stats": stats, "launches": launches,
                             "text_equal": text == direct}
                if r["status"] != 200 or text != direct:
                    raise AssertionError(f"spec pipeline {mode}: {text!r} vs "
                                         f"the direct {direct!r}")
                if out[mode]["verifies"] <= 0:
                    raise AssertionError(f"spec pipeline {mode}: no verify "
                                         f"round answered: {out[mode]}")
            g = out["gateway"]
            if not g["stats"]["accepted"] > 0:
                raise AssertionError(f"spec pipeline: no draft accepted: {g}")
            # The worker prefills (A); the gateway's drafter prefills (A)
            # and steps (D) on the card; no plain decode step ran.
            _expect_spec_launches("spec pipeline", g["launches"], {"A", "D"},
                                  "B", engine.runner.cfg.num_layers, {})
            if out["worker"]["stats"]["acks"] <= 0:
                raise AssertionError(f"spec pipeline worker mode sent no "
                                     f"ack credit: {out['worker']}")
            out["drafter_device"] = str(gw._spec_drafter.device)
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()
        return out

    return asyncio.run(go())


def spec_phase(dev) -> dict:
    """Speculative decoding on tinyllama-1.1b at full width (page 128,
    context 2048, 8 slots).  Weights: the permutation weights
    (``perm_params``) cut to ``SPEC_LAYERS`` layers; the draft is the same weights cut to 2 layers,
    written with the port's ``save_params`` and read back byte-equal, and
    served through ``spec_draft_path``; the seed-0 random weights.  The
    plain paged engine serves the reference: 4 echo prompts, 3 short
    prompts and LONG (ragged, kernel C) sent while they decode, greedy,
    ``SPEC_TOKENS`` tokens each.  Each speculative engine (n-gram on paged
    bf16 and int8 pools and on the contiguous cache, ``spec_draft=4``;
    the draft model from the checkpoint) serves the same streams and must
    give the same text and token ids; the echo streams must verify more
    than one token a step, the draft runner accept at least 90% of the
    drafts offered; the seeded sampled stream repeats.  Adaptive k:
    ``spec_draft=2, spec_draft_max=6`` on the permutation weights must
    grow k; the seed-0 random weights behind the permutation draft must
    pause (k = 0) and probe, and kernel B then launches.  Then
    ``spec_numerics`` and ``spec_pipeline``."""
    import tempfile

    from crowdllama_tpu_torch.engine.weights import (
        load_native_params,
        save_params,
    )
    from crowdllama_tpu_torch.models.config import get_config

    out: dict = {}
    params = _cut(perm_params(dev), SPEC_LAYERS)
    draft = _cut(params, 2)
    with tempfile.TemporaryDirectory() as tmp:
        dcfg = get_config(TINYLLAMA, num_layers=2)
        t0 = time.perf_counter()
        save_params(dcfg, draft, tmp, {"note": "permutation draft"})
        back = load_native_params(dcfg, tmp, dtype=draft["embed"].dtype,
                                  device=dev)
        out["checkpoint_s"] = time.perf_counter() - t0
        for name, t in (("embed", "embed"), ("lm_head", "lm_head")):
            if not torch.equal(back[name], draft[t]):
                raise AssertionError(f"draft checkpoint: {name} differs")
        for name, t in draft["layers"].items():
            if not torch.equal(back["layers"][name], t):
                raise AssertionError(f"draft checkpoint: layers/{name}")
        del back, draft
        plain = spec_engine(dev, params, "spec_plain", None, {"A", "B", "C"},
                            "B")
        ref = {n: {"ids": plain["ids"][n], "text": plain["requests"][n]["text"]}
               for n in plain["ids"]}
        runs = {"plain": plain}
        for name, ran, held, kw in (
                ("ngram_paged", {"A", "C"}, "B", {}),
                ("ngram_int8", {"A", "C_int8"}, "B_int8",
                 dict(kv_dtype="int8")),
                ("ngram_contiguous", {"A"}, "D",
                 dict(kv_layout="contiguous")),
                ("draft_paged", {"A", "C", "D"}, "B",
                 dict(spec_decode="draft", spec_draft_path=tmp))):
            _free_card()
            kw.setdefault("spec_decode", "ngram")
            runs[name] = spec_engine(dev, params, f"spec {name}", ref, ran,
                                     held, spec_draft=SPEC_DRAFT, **kw)
            for n, tps in runs[name]["echo_tokens_per_verify_step"].items():
                if not tps > 1.0:
                    raise AssertionError(f"spec {name}: echo stream {n} "
                                         f"verified {tps} tokens a step")
        per = runs["draft_paged"]["per_stream"].values()
        share = (sum(d["accepted"] for d in per)
                 / max(1, sum(d["offered"] for d in per)))
        runs["draft_paged"]["accepted_share"] = share
        if share < 0.9:
            raise AssertionError(f"spec draft: accepted {share} of the "
                                 f"drafts offered")
        _free_card()
        grow = spec_engine(dev, params, "spec adaptive_grow", ref, {"A"},
                           "B", streams=ECHO, long=False,
                           spec_decode="ngram", spec_draft=2,
                           spec_draft_max=6)
        if not max(grow["draft_len_trajectory"]) > 2:
            raise AssertionError(f"spec adaptive: k did not grow: "
                                 f"{grow['draft_len_trajectory']}")
        runs["adaptive_grow"] = grow
        _free_card()
        random_w = seed0_params(dev)
        pause = spec_engine(dev, random_w, "spec adaptive_pause", None,
                            {"A", "B", "C", "D"}, "B", probe_interval=8,
                            streams=NON_ECHO, spec_decode="draft",
                            spec_draft=2, spec_draft_max=6,
                            spec_draft_path=tmp)
        if not (0 in pause["draft_len_trajectory"] and pause["probes"] > 0):
            raise AssertionError(f"spec adaptive: no pause and probe on "
                                 f"random weights: {pause}")
        runs["adaptive_pause"] = pause
        _free_card()
        out["numerics"] = spec_numerics(dev, random_w)
        _free_card()
        out["pipeline"] = spec_pipeline(dev, params, tmp)
    del params
    perm_params.cache_clear()
    _free_card()
    out["runs"] = {n: {k: v for k, v in r.items() if k not in ("ids",)}
                   for n, r in runs.items()}
    out["echo_tokens_per_s"] = {n: r["echo_tokens_per_s"]
                                for n, r in runs.items()}
    out["serve_peak"] = {n: r["serve_peak"] for n, r in runs.items()}
    emit({"phase": "spec", "model": TINYLLAMA, "slots": 8, "page": 128,
          "reduced": {"num_layers": [22, SPEC_LAYERS]},
          "context": 2048, "tokens": SPEC_TOKENS, "draft_len": SPEC_DRAFT,
          **out, "logits_rtol": LOGIT_RTOL,
          "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()})
    return out


# ------------------------------------------------------------ autotune

AUTOTUNE_K = 8
AUTOTUNE_PASSES = 3
# The tuned passes' decode objective (ms a token) and the ragged-dispatch
# delay that breaches it: a delayed window emits at most 8 slots x 8
# steps, so 1 s over 64 tokens is 15.6 ms a token.
AUTOTUNE_DECODE_MS = 10.0
AUTOTUNE_DELAY_S = 1.0


def _dial_recorder(tuner) -> list:
    """Wrap ``tuner._apply``: each dial write as [dial, value, windows
    the tuner had folded in so far, moves, reverts, back-offs]."""
    log, apply, seen = [], tuner._apply, [0]
    on_window = tuner.on_window

    def counted(*a):
        seen[0] += 1
        return on_window(*a)

    def recorded(name, value):
        log.append([name, int(value), seen[0], tuner.moves, tuner.reverts,
                    tuner.backoffs])
        return apply(name, value)

    tuner._apply, tuner.on_window = recorded, counted
    return log


def autotune_run(dev, params, phase: str, streams: dict, interval: int,
                 fault: bool, ran: set, **engine_kw) -> dict:
    """One engine started with ``autotune=True`` (``interval``,
    ``slo_decode_ms``) on ``params``.  ``AUTOTUNE_PASSES`` passes of
    ``streams`` (each with LONG sent while they decode when LONG is in
    them) run untuned (the tuner detached), then the same passes tuned
    (``min_gain=1e6``: every trial reverts; burn windows of one, so one
    breaching window is a fast-burn edge), the middle pass under a
    ``scheduler.ragged_chunk`` delay of ``AUTOTUNE_DELAY_S`` at its first
    two ragged dispatches when ``fault``.  Launch counts are zeroed right
    before the tuned passes and read right after.  Checks: every stream
    done and full in both runs, the tuned token ids equal to the untuned
    ones, the kernels in ``ran`` launched; and that no megastep K is
    captured twice (each K the tuned run flies without a graph captures
    once; a revert replays)."""
    from crowdllama_tpu_torch.engine.autotune import BACKOFF_LOG
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.obs.slo import WindowBurn
    from crowdllama_tpu_torch.testing import faults

    long = "long" in streams
    streams = {k: v for k, v in streams.items() if k != "long"}

    async def passes(engine, faulted: bool) -> tuple[list, float]:
        out, wall = [], 0.0
        for i in range(AUTOTUNE_PASSES):
            plan = faults.FaultPlan(seed=0, rules=[faults.FaultRule(
                site="scheduler.ragged_chunk", action="delay",
                delay_s=AUTOTUNE_DELAY_S, times=2)])
            ctx = (faults.installed(plan) if faulted and i == 1
                   else contextlib.nullcontext())
            with ctx:
                served = await serve(engine, streams, SPEC_TOKENS, long=long)
            if faulted and i == 1 and long and not plan.log:
                raise AssertionError(f"{phase}: the ragged fault never "
                                     f"fired")
            out.append(served["requests"])
            wall += served["wall_s"]
        return out, wall

    async def go():
        torch.cuda.synchronize(dev)
        # The prefix cache off: every pass prefills LONG through ragged
        # steps (kernel C) at whatever chunk the dials give then.
        engine = TorchEngine(params=params, device=dev, model=TINYLLAMA,
                             autotune=True, autotune_interval=interval,
                             slo_decode_ms=AUTOTUNE_DECODE_MS,
                             kv_prefix_cache=False, **engine_kw)
        t0 = time.perf_counter()
        await engine.start()
        start_s = time.perf_counter() - t0
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        sched, tuner, runner = engine.scheduler, engine.autotuner, \
            engine.runner
        if tuner is None or sched._autotune is not tuner:
            raise AssertionError(f"{phase}: the engine built no tuner")
        tuner.min_gain = 1e6
        tuner.burn = WindowBurn(objective_ms=AUTOTUNE_DECODE_MS, short=1,
                                long=1)
        try:
            sched.attach_autotuner(None)
            untuned, untuned_wall = await passes(engine, False)
            before = runner._graphs  # None until a first megastep flight
            keys0 = set(before._graphs) if before is not None else set()
            captures0 = before.captures if before is not None else 0
            ks: list[int] = []
            mega = runner.decode_megastep

            def counted(state, k, **kw):
                ks.append(k)
                return mega(state, k, **kw)

            runner.decode_megastep = counted
            dials = _dial_recorder(tuner)
            sched.attach_autotuner(tuner)
            b0 = BACKOFF_LOG.snapshot()[0]
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_launches()
            tuned, tuned_wall = await passes(engine, fault)
            launches = _launches()
            peak = torch.cuda.max_memory_allocated(dev)
            backoff_total, backoff_last = BACKOFF_LOG.snapshot()
            del runner.decode_megastep
            graphs = runner._graphs
            gauges = engine.obs_gauges()
            described = engine.describe()["autotune"]
            graph_rows = {}
            if graphs is not None:
                for key, g in graphs._graphs.items():
                    graph_rows[f"K{key[3]}{'_sampled' if key[4] else ''}"] = {
                        "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                        "replays": g.replays, "mid_serve": key not in keys0}
            new_captures = (graphs.captures - captures0
                            if graphs is not None else 0)
            nkeys = len(graphs._graphs) if graphs is not None else 0
        finally:
            await engine.stop()
        return dict(start_s=start_s, untuned=untuned, tuned=tuned,
                    untuned_wall=untuned_wall, tuned_wall=tuned_wall,
                    launches=launches, peak=peak, dials=dials, ks=ks,
                    keys0=keys0, new_captures=new_captures, nkeys=nkeys,
                    captures=(graphs.captures if graphs is not None else 0),
                    graph_rows=graph_rows, described=described,
                    gauges=gauges, backoffs_logged=backoff_total - b0,
                    backoff_last=backoff_last)

    r = asyncio.run(go())
    ntok = 0
    for i, (u, t) in enumerate(zip(r["untuned"], r["tuned"])):
        for name in u:
            for run, v in (("untuned", u[name]), ("tuned", t[name])):
                if not (v["done"] and len(v["ids"]) == SPEC_TOKENS):
                    raise AssertionError(f"{phase}: {run} pass {i} stream "
                                         f"{name} ended {v}")
            if t[name]["ids"] != u[name]["ids"]:
                raise AssertionError(
                    f"{phase}: pass {i} stream {name}: tuned ids "
                    f"{t[name]['ids']} differ from untuned "
                    f"{u[name]['ids']}")
            ntok += SPEC_TOKENS
    _expect_launches({k: v for k, v in r["launches"].items() if k in ran},
                     ran, phase)
    d = r["described"]
    # Each K flown by a megastep flight without a graph before the tuned
    # run captured once, and no key twice: a revert replays its graph.
    flown = {k for k in r["ks"]}
    new_k = {k for k in flown
             if not any(key[3] == k for key in r["keys0"])}
    if r["new_captures"] != len(new_k) or r["captures"] != r["nkeys"]:
        raise AssertionError(f"{phase}: {r['new_captures']} captures in the "
                             f"tuned run for new K {sorted(new_k)} (flown "
                             f"{sorted(flown)}); {r['captures']} captures "
                             f"for {r['nkeys']} graphs")
    g = r["gauges"]
    if g["autotune_moves_total"] != float(d["moves"]):
        raise AssertionError(f"{phase}: gauges {g} vs describe {d}")
    return {"start_s": r["start_s"], "describe": d,
            "dial_trajectory": r["dials"],
            "megastep_k_flown": sorted(flown), "new_k": sorted(new_k),
            "captures_in_tuned_run": r["new_captures"],
            "graphs": r["graph_rows"], "serve_peak": r["peak"],
            "launches": r["launches"],
            "backoffs_logged": r["backoffs_logged"],
            "backoff_last": r["backoff_last"],
            "tokens_per_s": {"untuned": ntok / r["untuned_wall"],
                             "tuned": ntok / r["tuned_wall"]},
            "wall_s": {"untuned": r["untuned_wall"],
                       "tuned": r["tuned_wall"]}}


def autotune_phase(dev) -> dict:
    """The autopilot on tinyllama-1.1b at full width and depth (22 layers,
    8 slots, context 2048, page 128) on the permutation weights (every
    attention route gives the same greedy tokens, and A, B and C still
    launch).  Sub-run ``paged``: ``megastep_k=8``, ragged on, 8 streams
    of ``SPEC_TOKENS`` tokens with LONG sent while they decode, three
    passes untuned then three tuned (interval 2) under the ragged delay:
    streams equal, >= 3 moves, >= 1 revert, >= 1 back-off, each new K
    captured once (its capture seconds and pool bytes printed), A, B and
    C launched.  Sub-run ``spec``: n-gram speculation with the adaptive
    draft (``spec_draft_max=4``) on the echo and short prompts, tuned at
    interval 1 (the draft cap and pipeline depth dials among its moves):
    streams equal, >= 2 moves."""
    t0 = time.perf_counter()
    params = perm_params(dev)
    streams = {**{f"short{i}": (SHORT[i], {}) for i in range(4)}, **ECHO,
               "long": (LONG, {})}
    out = {"paged": autotune_run(dev, params, "autotune paged", streams, 2,
                                 True, {"A", "B", "C"},
                                 megastep_k=AUTOTUNE_K)}
    d = out["paged"]["describe"]
    if not (d["moves"] >= 3 and d["reverts"] >= 1 and d["backoffs"] >= 1):
        raise AssertionError(f"autotune paged: {d}")
    _free_card()
    out["spec"] = autotune_run(dev, params, "autotune spec",
                               {**ECHO, **NON_ECHO}, 1, False, {"A"},
                               spec_decode="ngram", spec_draft=SPEC_DRAFT,
                               spec_draft_max=SPEC_DRAFT)
    sd = out["spec"]["describe"]
    moved = {row[0] for row in out["spec"]["dial_trajectory"]}
    if sd["moves"] < 2 or "draft_k" not in moved:
        raise AssertionError(f"autotune spec: {sd}, moved {moved}")
    del params
    perm_params.cache_clear()
    emit({"phase": "autotune", "model": TINYLLAMA, "slots": 8, "page": 128,
          "context": 2048, "tokens": SPEC_TOKENS,
          "passes": AUTOTUNE_PASSES, "decode_ms": AUTOTUNE_DECODE_MS,
          "delay_s": AUTOTUNE_DELAY_S, **out,
          "seconds": time.perf_counter() - t0,
          "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()})
    return out


# ------------------------------------------------------------ share

#: the name worker 1 serves the hf phase's tinyllama directory under (outside
#: the registry: only worker 1 can share it)
SHARE_NAME = "hf-tinyllama-chat"
SHARE_TOKENS = 32


def _sha256_tree(d: str) -> dict:
    """name -> SHA-256 of every checkpoint file of directory ``d``."""
    from pathlib import Path

    from crowdllama_tpu_torch.net.model_share import _sha256_file, _shareable

    return {p.name: _sha256_file(p) for p in sorted(Path(d).iterdir())
            if _shareable(p.name)}


async def _cli(root: str, *argv: str, timeout: float = 300.0) -> dict:
    """``python -m crowdllama_tpu_torch.cli.main <argv>`` as a subprocess:
    its exit code and output."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "crowdllama_tpu_torch.cli.main", *argv,
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    return {"rc": proc.returncode, "out": out.decode(),
            "err": err.decode()[-2000:]}


def share_phase(dev, hf_dir: str) -> dict:
    """Swarm model sharing, every module the port's own, on 127.0.0.1: a
    DHT node, two torch workers and a consumer ``Peer`` with its
    ``Gateway``.  Worker 1 serves the hf phase's tinyllama-1.1b directory
    (full width, ``HF_TINY_LAYERS`` layers, bf16, two shards) through
    ``model_path`` under ``SHARE_NAME``, a name outside the registry;
    worker 2 serves tinyllama-1.1b's seed-0 weights and has an empty
    ``models_dir``.  A client host times the ``manifest`` op on worker 1
    (the SHA-256 of every file, a cold hash cache), then sends worker 2
    the ``pull`` op (what the gateway's ``/api/pull`` proxies): worker 2
    fetches every file from worker 1, verifies it and hot-registers the
    model (fetch GB/s and registration seconds apart).  The pulled files'
    SHA-256 must equal the donor's; ``/api/pull`` through the gateway
    then answers 200 for the model (served) and 404 naming the failed
    swarm pull for a name nobody has.  Worker 2's first stream on the
    pulled model (the long prompt, greedy, ``SHARE_TOKENS`` tokens; its
    TTFT and the launches of A, B and C, counts zeroed right before it)
    must equal worker 1's stream of the same prompt token for token: the
    same kernels on the same bytes.  Last the CLI in subprocesses:
    ``pull`` into a third directory (hashes equal too), ``list``,
    ``list --gateway``, ``show`` and ``rm`` on it, each exit code."""
    import os
    import tempfile

    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.core.protocol import MODEL_PROTOCOL
    from crowdllama_tpu_torch.engine.engine import FakeEngine
    from crowdllama_tpu_torch.engine.multi import MultiEngine
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.net import model_share
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.net.host import (
        read_json_frame,
        write_json_frame,
    )
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    root = os.path.dirname(os.path.abspath(__file__))
    key = Ed25519PrivateKey.generate
    want = _sha256_tree(hf_dir)
    nbytes_ = sum(os.path.getsize(os.path.join(hf_dir, n)) for n in want)

    async def stream(multi, model: str) -> dict:
        eng = multi._engines[model]
        eng.tokenizer = _IdRecorder(eng.tokenizer)
        ids: list[int] = []
        _STREAM_IDS.set(ids)
        final = None
        async for chunk in multi.generate(LONG, model=model,
                                          max_tokens=SHARE_TOKENS):
            final = chunk
        return {"ids": ids, "done": final.done,
                "prompt_tokens": final.prompt_tokens,
                "ttft_ms": (final.queue_ns + final.prefill_ns) / 1e6}

    async def go(tmp: str) -> dict:
        boot, _ = await new_host_and_dht(key(), listen_host="127.0.0.1")
        baddr = f"127.0.0.1:{boot.listen_port}"
        node = dict(listen_host="127.0.0.1", bootstrap_peers=[baddr])
        cfg1 = Configuration(model=SHARE_NAME, model_path=hf_dir, **node)
        cfg2 = Configuration(model=TINYLLAMA, models_dir=os.path.join(
            tmp, "models2"), **node)
        e1, e2 = MultiEngine(cfg1, device=dev), MultiEngine(cfg2, device=dev)
        w1, w2 = Peer(key(), cfg1, e1), Peer(key(), cfg2, e2)
        consumer = Peer(key(), Configuration(**node), FakeEngine(models=[]),
                        worker_mode=False)
        gw = Gateway(consumer, port=0, host="127.0.0.1")
        client, _ = await new_host_and_dht(key(), listen_host="127.0.0.1")
        started: list = []
        out: dict = {}
        try:
            for part in (e1, w1, e2, w2, consumer, gw):
                await part.start()
                started.append(part)
            t0 = time.perf_counter()
            while not any(SHARE_NAME in p.resource.supported_models
                          for p in w2.peer_manager.get_healthy_peers()):
                if time.perf_counter() - t0 > 60:
                    raise AssertionError("share: worker 2 never saw worker 1")
                await asyncio.sleep(0.1)

            # The manifest: every file hashed on worker 1 (cold cache).
            t0 = time.perf_counter()
            s = await client.new_stream(w1.host.contact, MODEL_PROTOCOL)
            try:
                await write_json_frame(s.writer, {"op": "manifest",
                                                  "model": SHARE_NAME})
                manifest = await read_json_frame(
                    s.reader, model_share.MANIFEST_TIMEOUT)
            finally:
                s.close()
            out["manifest_s"] = time.perf_counter() - t0
            if not manifest.get("ok") or {f["name"]: f["sha256"] for f in
                                          manifest["files"]} != want:
                raise AssertionError(f"share: manifest {manifest}")

            # The pull op on worker 2: fetch and hot registration timed apart.
            spans: dict = {}
            fetch, add = model_share.fetch_model, e2.add_model

            async def timed_fetch(*a, **kw):
                t = time.perf_counter()
                try:
                    return await fetch(*a, **kw)
                finally:
                    spans["fetch_s"] = time.perf_counter() - t

            async def timed_add(*a, **kw):
                t = time.perf_counter()
                try:
                    return await add(*a, **kw)
                finally:
                    spans["register_s"] = time.perf_counter() - t

            model_share.fetch_model, e2.add_model = timed_fetch, timed_add
            try:
                t0 = time.perf_counter()
                path = await model_share.request_pull(
                    client, w2.host.contact, SHARE_NAME)
                out["pull_s"] = time.perf_counter() - t0
            finally:
                model_share.fetch_model = fetch
                del e2.add_model
            out.update(spans, path_ran="pull op sent to worker 2",
                       bytes=nbytes_,
                       fetch_gb_per_s=nbytes_ / spans["fetch_s"] / 1e9)
            got = await asyncio.to_thread(_sha256_tree, path)
            out["hashes_equal"] = got == want
            if not (out["hashes_equal"] and e2.models == [TINYLLAMA,
                                                          SHARE_NAME]):
                raise AssertionError(f"share: pulled {got} into {path}, "
                                     f"serving {e2.models}")

            # /api/pull through the gateway: served, then absent.
            gport = gw.port
            t0 = time.perf_counter()
            while not any(p.peer_id == w2.peer_id
                          and SHARE_NAME in p.resource.supported_models
                          for p in consumer.peer_manager
                          .get_healthy_peers()):
                if time.perf_counter() - t0 > 60:
                    raise AssertionError("share: the gateway never saw "
                                         "worker 2 serve the pulled model")
                await asyncio.sleep(0.1)
            served = await asyncio.to_thread(
                _http, gport, "POST", "/api/pull",
                {"model": SHARE_NAME, "stream": True})
            absent = await asyncio.to_thread(
                _http, gport, "POST", "/api/pull",
                {"model": "no-such-model", "stream": False})
            out["api_pull"] = {
                "served": [served["status"], _ndjson(served)],
                "absent": [absent["status"],
                           json.loads(absent["lines"][0][1])["error"]]}
            if not (served["status"] == 200 and _ndjson(served)[-1]
                    == {"status": "success"} and absent["status"] == 404
                    and "swarm pull failed" in out["api_pull"]["absent"][1]):
                raise AssertionError(f"share: /api/pull {out['api_pull']}")

            # Worker 2's first stream on the pulled model, then worker 1's.
            _zero_launches()
            first = await stream(e2, SHARE_NAME)
            launches = _launches()
            ref = await stream(e1, SHARE_NAME)
            out["stream"] = {
                "prompt_tokens": first["prompt_tokens"],
                "ttft_ms": first["ttft_ms"],
                "worker1_ttft_ms": ref["ttft_ms"],
                "launches": {k: launches[k] for k in ("A", "B", "C")},
                "tokens_equal_to_worker1": first["ids"] == ref["ids"]}
            _expect_launches(launches, {"B"} | {k for k in ("A", "C")
                                                if launches[k]}, "share")
            if not (first["done"] and len(first["ids"]) == SHARE_TOKENS
                    and first["ids"] == ref["ids"]
                    and launches["A"] + launches["C"] > 0):
                raise AssertionError(f"share: stream {out['stream']} "
                                     f"{first['ids']} vs {ref['ids']}")

            # The CLI, in subprocesses.
            dir3 = os.path.join(tmp, "models3")
            cli = {"pull": await _cli(
                root, "pull", SHARE_NAME, "--bootstrap-peers", baddr,
                "--models-dir", dir3, "--key-path",
                os.path.join(tmp, "cli.key"))}
            pulled3 = cli["pull"]["out"].strip()
            cli_hashes = (await asyncio.to_thread(_sha256_tree, pulled3)
                          if cli["pull"]["rc"] == 0 else {})
            cli["list"] = await _cli(root, "list", "--models-dir", dir3)
            cli["list_gateway"] = await _cli(
                root, "list", "--gateway", f"http://127.0.0.1:{gport}")
            cli["show"] = await _cli(root, "show", SHARE_NAME,
                                     "--models-dir", dir3)
            cli["rm"] = await _cli(root, "rm", SHARE_NAME, "--models-dir",
                                   dir3)
            out["cli"] = {k: v["rc"] for k, v in cli.items()}
            out["cli_hashes_equal"] = cli_hashes == want
            if not (all(v["rc"] == 0 for v in cli.values())
                    and cli_hashes == want
                    and SHARE_NAME in cli["list"]["out"]
                    and SHARE_NAME in cli["list_gateway"]["out"].split()
                    and "checkpoint:   " + pulled3 in cli["show"]["out"]
                    and not os.path.exists(pulled3)):
                raise AssertionError(f"share: cli {cli}")
        finally:
            await client.close()
            for part in reversed(started):
                await part.stop()
            await boot.close()
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="share") as tmp:
        out = asyncio.run(go(tmp))
    return {"phase": "share", "model": SHARE_NAME, "source": TINYLLAMA,
            **out, "seconds": time.perf_counter() - t0,
            "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}


# ------------------------------------------------------------ distill

#: ``distill-draft``'s arguments on the card: a 2-layer student on
#: 16 x 64-token batches, a corpus and a step count that keep the phase
#: near half a minute
DISTILL = {"--draft-layers": "2", "--seq-len": "64", "--batch": "16",
           "--corpus-seqs": "64", "--steps": "40"}
#: the Gemma-2-9b teacher's run: the same shapes, 16 steps (a step's fp32
#: teacher forward alone is 18.9 TFLOP)
DISTILL_GEMMA9 = {**DISTILL, "--steps": "16"}
#: the context of the Gemma-2-9b spec stream's engine (its pool at the
#: full 8,192 would hold 22.6 GB)
DISTILL_SPEC_CONTEXT = 1024
#: the student's gradient through A's autograd.Function against the plain
#: function's, per leaf: max |diff| over max |plain gradient|
GRAD_RTOL = 1e-4
#: one batch's teacher logits through A's and D's fp32 entries against the
#: plain route at full depth: max |gap| over max |logit|.  The entries
#: differ from the plain versions by fp32 summation order and 3xTF32's
#: truncation (~1e-6 of an attention output); random layers at the port's
#: norm init amplify one perturbation ~100x on its way to the logits (PR
#: 25's ``rounding_probe``: one bf16 ulp, 2^-8, moved Gemma-2-9b's logits
#: by 39% of scale), so ~1e-4 is expected and 1e-3 is the bound; one TF32
#: pass (2^-11) would part them by ~5e-2.
TEACHER_LOGIT_RTOL = 1e-3
#: the keys of ``distill_draft``'s result that ``cli_child`` reports
DISTILL_FIGURES = ("losses", "agreement", "checkpoint", "rollout_s",
                   "rollout_tokens", "step_ms")


def _distill_args(args: dict) -> dict:
    """``distill-draft``'s numeric flags as ``DistillConfig`` fields."""
    return {k.lstrip("-").replace("-", "_"): int(v) for k, v in args.items()}


def distill_memory(cfg, args: dict) -> dict:
    """The distillation's peak on the card, reckoned from the
    configuration: the fp32 teacher, the student's params, gradients and
    Adam moments (updated in place), the new params an Adam step builds
    beside the old, the teacher's logits for a batch, and two temporaries
    the size of the largest leaf (the tied embedding) inside the step."""
    from crowdllama_tpu_torch.train import distill as td

    a = _distill_args(args)
    student = td.draft_config_for(cfg, a["draft_layers"]).param_count() * 4
    parts = {"teacher": cfg.param_count() * 4, "student_x5": 5 * student,
             "teacher_logits": a["batch"] * a["seq_len"] * cfg.vocab_size * 4,
             "temporaries": 2 * cfg.vocab_size * cfg.hidden_size * 4}
    return {**parts, "total": sum(parts.values())}


def teacher_logits_check(teacher: dict, cfg, tokens, logits) -> dict:
    """The teacher's logits for one batch through the fp32 entries of A and
    D against the plain route: ``logits`` (the trainer's, through A)
    against a prefill through ``prefill_attention_ref``; then every
    position of the batch decoded one token a step (teacher forcing) over
    two fp32 caches, one through D's entry, one through its plain version.
    Each gap is max |kernel - plain| over max |plain logit|."""
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )
    from crowdllama_tpu_torch.train import distill as td

    def gap(kernel, plain):
        return float((kernel - plain).abs().max() / plain.abs().max())

    b, s = tokens.shape
    with torch.inference_mode():
        plain = T.prefill([teacher], cfg, tokens, td._positions(tokens),
                          attention=prefill_attention_ref)[0].float()
        out = {"prefill": gap(logits, plain)}
        del plain
        dev = tokens.device
        shape = (cfg.num_layers, b, cfg.num_kv_heads, s,
                 cfg.resolved_head_dim())
        caches = {fn: (torch.zeros(shape, device=dev),
                       torch.zeros(shape, device=dev))
                  for fn in (flash_decode_attention, decode_attention_plain)}
        rope = [T.rope_for(cfg, dev)]
        worst = 0.0
        for i in range(s):
            pos = torch.full((b,), i, dtype=torch.int32, device=dev)
            step = [T.decode_step([teacher], cfg, tokens[:, i], pos, kc, vc,
                                  pos + 1, rope=rope, attention=fn)[0]
                    for fn, (kc, vc) in caches.items()]
            worst = max(worst, gap(*step))
        out["decode"] = worst
        del caches
    return dict(out, rtol=TEACHER_LOGIT_RTOL)


def distill_grad_check(dev, first_loss: float, teacher: str = TINYLLAMA,
                       teacher_path: str = "",
                       args: dict = DISTILL) -> dict:
    """The student's step-1 gradient, in this process on the card: the
    run's teacher (``teacher``, or the configuration ``teacher_path``
    holds, seed-0 weights in fp32), initial student and first batch,
    rebuilt as ``distill_draft`` builds them; the gradient of
    ``distill_loss`` through kernel A's ``PrefillAttention`` against the
    same through the plain ``prefill_attention_ref``; and the batch's
    teacher logits kernel against plain (``teacher_logits_check``)."""
    import numpy as np

    from crowdllama_tpu_torch.engine.weights import (
        init_params,
        resolve_model_config,
    )
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.train import distill as td

    a = _distill_args(args)
    cfg = resolve_model_config(teacher, teacher_path)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    dcfg = td.draft_config_for(cfg, a["draft_layers"])
    _, k_rand, k_init = td.distill_keys(0)
    corpus = td.rollout_corpus(cfg, params, k_rand, a["corpus_seqs"],
                               a["seq_len"], 0.0)
    rows = torch.randperm(corpus.shape[0], generator=torch.Generator()
                          .manual_seed(0))[:a["batch"]]
    tokens = torch.from_numpy(corpus[rows.numpy()]).long().to(dev)
    student = td.init_draft_params(dcfg, k_init, dev)
    for k in ("embed", "lm_head", "final_norm"):
        if k in params:
            student[k] = params[k].clone()
    tl = td._teacher_logits(params, cfg, tokens)
    logits = teacher_logits_check(params, cfg, tokens, tl)
    del params
    grads, losses = [], []
    for attention in (None, prefill_attention_ref):
        leaves = td._tree_map(lambda x: x.detach().requires_grad_(), student)
        kw = {} if attention is None else {"attention": attention}
        loss, _ = td.distill_loss(leaves, dcfg, tl, tokens, 0.5, 2.0, **kw)
        grads.append(torch.autograd.grad(loss, td._leaves(leaves)))
        losses.append(float(loss.detach()))
    errs = [float((g - p).abs().max() / p.abs().max())
            for g, p in zip(*grads)]
    del student, tl, grads
    _free_card()
    return {"loss_kernel": losses[0], "loss_plain": losses[1],
            "cli_first_loss": first_loss,
            "max_rel_err": max(errs), "leaves": len(errs),
            "rtol": GRAD_RTOL,
            "first_loss_equal": bool(np.isclose(losses[0], first_loss,
                                                rtol=1e-5)),
            "teacher_logits": logits}


def _distill_spec_stream(dev, ckpt: str, engine_kw: dict) -> dict:
    """One 32-token greedy stream with the draft checkpoint ``ckpt`` as
    ``spec_draft_path`` (``engine_kw`` names the served model and its
    weights); it must end done and verify drafts."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    async def spec():
        engine = TorchEngine(device=dev, spec_decode="draft",
                             spec_draft=SPEC_DRAFT, spec_draft_path=ckpt,
                             **engine_kw)
        await engine.start()
        try:
            final = None
            async for chunk in engine.generate(SHORT[2], max_tokens=32):
                final = chunk
            return final, engine.describe()
        finally:
            await engine.stop()

    final, desc = asyncio.run(spec())
    stats = desc.get("spec_decode", {})
    out = {"done": final.done, "completion_tokens": final.completion_tokens,
           "spec_decode": stats}
    if not (final.done and final.completion_tokens == 32
            and stats.get("verify_steps", 0) > 0):
        raise AssertionError(f"distill: spec stream {out}")
    return out


def distill_phase(dev, phase: str = "distill", teacher: str = TINYLLAMA,
                  args: dict = DISTILL,
                  teacher_config: dict | None = None) -> tuple[dict, str]:
    """``distill-draft`` on the card through the port's CLI
    (``crowdllama_tpu_torch.cli.main``, in a process of its own through
    ``cli_child``, which reports its launch counts, its peak memory and
    the run's figures): the teacher at full width and depth in fp32 (its
    seed-0 random weights; tinyllama-1.1b's 4.4 GB by default, or with
    ``teacher_config`` the model whose ``config.json`` that dict is,
    written into the directory passed as ``--teacher-path``), the student
    ``args``' layers on ``args``' corpus and steps.  The run's figures
    give the rollout's seconds and tokens/s, each train step's device ms
    (CUDA events), the losses and the agreement.  Checks: the loss falls;
    kernel D's fp32 entry launches once per layer per rollout step and A's
    once per layer per train step (teacher and student layers), and no
    other kernel; the student's step-1 gradient through A's
    ``autograd.Function`` within ``GRAD_RTOL`` of the plain function's and
    one batch's teacher logits within ``TEACHER_LOGIT_RTOL`` of the plain
    route's (``distill_grad_check``); the checkpoint loads, and serves as
    ``spec_draft_path`` behind the teacher's weights in bf16 in one short
    greedy stream that verifies drafts.  Returns the line and the
    launches of A_fp32 and D_fp32."""
    import os
    import tempfile

    from crowdllama_tpu_torch.engine.weights import (
        init_params,
        load_native_params,
        native_config_from_dir,
        resolve_model_config,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="distill") as tmp:
        ckpt = os.path.join(tmp, "draft")
        path = ""
        if teacher_config is not None:
            path = os.path.join(tmp, "teacher")
            os.makedirs(path)
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(teacher_config, f)
        cfg = resolve_model_config(teacher, path)
        argv = ["distill-draft", "--teacher", teacher, "--out", ckpt,
                *(["--teacher-path", path] if path else []),
                *[x for kv in args.items() for x in kv]]

        async def run():
            proc, res = await _spawn_cli(root, tmp, phase,
                                         "crowdllama_tpu_torch.cli.main",
                                         *argv)
            rc = await asyncio.wait_for(proc.wait(), 600)
            proc.err_file.close()
            if rc != 0 or not os.path.exists(res):
                with open(os.path.join(tmp, f"{phase}.err")) as f:
                    raise AssertionError(f"{phase}: exited {rc}: "
                                         f"{f.read()[-3000:]}")
            with open(res) as f:
                return json.load(f)

        child = asyncio.run(run())
        cli_s = time.perf_counter() - t0
        rep, launches = child["result"], child["launches"]
        a = _distill_args(args)
        steps, seq = a["steps"], a["seq_len"]
        layers, draft_layers = cfg.num_layers, a["draft_layers"]
        step_ms = sorted(rep["step_ms"][1:])
        memory = distill_memory(cfg, args)
        out = {"cli_seconds": cli_s, "rollout_s": rep["rollout_s"],
               "rollout_tokens": rep["rollout_tokens"],
               "rollout_tokens_per_s": rep["rollout_tokens"]
               / rep["rollout_s"],
               "step_ms_first": rep["step_ms"][0],
               "step_ms_median": step_ms[len(step_ms) // 2],
               "step_ms_min": step_ms[0],
               "loss_first": rep["losses"][0], "loss_last": rep["losses"][-1],
               "agreement": rep["agreement"], "launches": launches,
               "max_memory_allocated": child["max_memory_allocated"],
               "parent_memory_allocated": (torch.cuda.memory_allocated(dev)
                                           if dev.type == "cuda" else 0),
               "memory_predicted": memory,
               "memory_over_predicted": child["max_memory_allocated"]
               / memory["total"]}
        _expect_launches(launches, {"A_fp32", "D_fp32"}, phase)
        if not (rep["losses"][-1] < rep["losses"][0]
                and launches["D_fp32"] == layers * seq
                and launches["A_fp32"] == (layers + draft_layers) * steps):
            raise AssertionError(f"{phase}: {out}")

        out["gradient"] = distill_grad_check(dev, rep["losses"][0], teacher,
                                             path, args)
        grad, logit = out["gradient"], out["gradient"]["teacher_logits"]
        if not (grad["max_rel_err"] <= GRAD_RTOL and grad["first_loss_equal"]
                and max(logit["prefill"], logit["decode"])
                <= TEACHER_LOGIT_RTOL):
            raise AssertionError(f"{phase}: gradient {grad}")

        # The checkpoint: loads, then drafts for the teacher's weights.
        dcfg = native_config_from_dir(ckpt)
        back = load_native_params(dcfg, ckpt, dtype=torch.float32)
        out["checkpoint"] = {"layers": dcfg.num_layers, "tensors": len(
            _flat(back))}
        del back
        if teacher_config is None:
            served = dict(params=seed0_params(dev), model=teacher)
        else:
            params = init_params(cfg, seed=0, device=dev)
            _zero_eos_params(params)
            served = dict(params=params, model=teacher, model_config=cfg,
                          max_context_length=DISTILL_SPEC_CONTEXT)
        out["spec_stream"] = _distill_spec_stream(dev, ckpt, served)
        del served
    _free_card()
    return ({"phase": phase, "teacher": teacher, "teacher_dtype": "float32",
             "layers": layers, "head_dim": cfg.resolved_head_dim(),
             "args": args, **out,
             "seconds": time.perf_counter() - t0,
             "card": torch.cuda.get_device_name(0),
             "nvidia_smi": nvidia_smi()},
            {k: launches[k] for k in ("A_fp32", "D_fp32")})


def distill_gemma2_phase(dev) -> tuple[dict, str]:
    """``distill_phase`` with a Gemma-2-9b teacher at full width and all
    42 layers in fp32 (head dim 256): its directory holds Google's
    published ``config.json`` with ``tie_word_embeddings`` stated at
    Hugging Face's default (``hf_fixtures.GEMMA2_9B_TIED_CONFIG``), no
    weights, so the CLI draws the seed-0 init on the card (37 GB)."""
    from crowdllama_tpu_torch.testing.hf_fixtures import (
        GEMMA2_9B_TIED_CONFIG,
    )

    return distill_phase(dev, "distill_gemma2_9b", GEMMA9, DISTILL_GEMMA9,
                         GEMMA2_9B_TIED_CONFIG)


# row -> (name, source, TPU kernel it replaces); the name is the C symbol,
# for F B's symbol launched once over every tensor-parallel rank on the
# card (the ranks folded into its grid).
# ------------------------------------------------ kernel G, MoE, quantization

MIXTRAL = "mixtral-8x7b"
# Mixtral's expert bank: 8 experts, hidden 4096, expert width 14336.
MIX_E, MIX_D, MIX_F = 8, 4096, 14336
# Kernel G against its plain version: within 0.0156 of the output's scale
# (max |plain|), as A and C are held (one bf16 rounding of an output of
# the scale's order, plus fp32 order noise over K up to 14,336 terms).
GEMM_RTOL = 0.0156
GEMM_FORMATS = ("bf16", "int8", "int4")
GEMM_ROW = {"bf16": "G", "int8": "G_int8", "int4": "G_int4"}
# Mixtral's decode batches (2 rows a token: its top-2 experts) and one
# prefill of 1,024 tokens; llama-3-8b's dense products (E 1).
GEMM_DECODE_SLOTS = (1, 8, 64)
GEMM_PREFILL_TOKENS = 1024
GEMM_DENSE = ((8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
              (8, 14336, 4096), (512, 4096, 4096), (512, 4096, 14336),
              (512, 14336, 4096))
# The kernels line's row of each format: Mixtral's 8-slot decode, gate/up
# direction (16 rows spread over the experts), the main path's shape.
GEMM_ROW_CASE = "decode8_gate"
MOE_TOKENS = 16
MOE_CONTEXT = 2048
MOE_K = 4
# Depths of the reduced Mixtral cells.
MOE_BF16_LAYERS, MOE_INT4_LAYERS, MOE_TP_LAYERS = 4, 8, 2


def _bank(dev, gen, fmt: str, e: int, k: int, n: int):
    """A random expert bank [E, K, N] (2-D when E is 1) in ``fmt``."""
    from crowdllama_tpu_torch.ops.quant import (
        quantize_weight,
        quantize_weight_int4,
    )

    w = (torch.randn((e, k, n), generator=gen, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    if e == 1:
        w = w[0]
    if fmt == "int8":
        return quantize_weight(w)
    if fmt == "int4":
        return quantize_weight_int4(w)
    return w


def _weight_bytes(w, experts: int) -> int:
    """Bytes of ``experts`` experts' values and scales of the bank."""
    q = getattr(w, "q", w)
    per = nbytes(q) // (q.shape[0] if q.dim() == 3 else 1)
    if hasattr(w, "s"):
        per += nbytes(w.s) // (q.shape[0] if q.dim() == 3 else 1)
    return per * experts


def check_gemm(dev, gen, w, fmt: str, sizes: list[int] | None,
               m: int) -> dict:
    """Kernel G on ``m`` rows grouped by ``sizes`` (None: the dense
    product, a bank of one) against its plain version; the kernel's, the
    plain version's and one library call's device ms, and the bound from
    the touched experts' bytes and the rows' operations."""
    from crowdllama_tpu_torch.ops.cuda.gemm import (
        gemm_launch_shape,
        grouped_gemm,
        grouped_gemm_plain,
    )

    q = getattr(w, "q", w)
    k = q.shape[-2]
    n = w.shape[-1]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    off = None
    if sizes is not None:
        off = torch.tensor([0, *itertools.accumulate(sizes)],
                           dtype=torch.int32, device=dev)
    got = grouped_gemm(x, w, off)
    want = grouped_gemm_plain(x, w, off)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"G {fmt}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= GEMM_RTOL * scale:
        raise AssertionError(f"G {fmt} m={m} k={k} n={n} sizes={sizes}: "
                             f"max abs err {err} beyond {GEMM_RTOL} of "
                             f"{scale}")
    touched = 1 if sizes is None else sum(1 for v in sizes if v)
    moved = (_weight_bytes(w, touched) + nbytes(x, got)
             + (0 if off is None else nbytes(off)))
    bound, by = bound_ms(moved, 2 * m * k * n)
    plan = gemm_launch_shape(x, w, off)
    row = {"rows": m, "k": k, "n": n, "experts_touched": touched,
           "schedule": plan["schedule"], "split": plan["split"],
           "grid": list(plan["grid"]), "wave": plan.get("wave"),
           "max_abs_err": err, "scale": scale,
           "ms": time_ms(lambda: grouped_gemm(x, w, off)),
           "plain_ms": time_ms(lambda: grouped_gemm_plain(x, w, off),
                               iters=3),
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    if fmt == "bf16" and sizes is None:
        row["library_ms"] = time_ms(lambda: torch.matmul(x, w))
        row["library"] = "torch.matmul"
    elif fmt == "bf16" and hasattr(torch, "_grouped_mm"):
        ends = off[1:].contiguous()
        ref = torch._grouped_mm(x, w, offs=ends)
        torch.cuda.synchronize()
        row["library_max_abs_diff"] = float((ref.float() - want.float())
                                            .abs().max())
        row["library_ms"] = time_ms(lambda: torch._grouped_mm(x, w,
                                                              offs=ends))
        row["library"] = "torch._grouped_mm"
    elif fmt == "int8" and sizes is None:
        row.update(_int8pack_mm_ms(x, w, want))
    elif fmt == "int4" and sizes is None:
        row.update(_int4pack_mm_ms(x, w, want))
    else:
        row["library"] = ("none: no PyTorch call dequantises a bank of "
                          "experts in the product" if fmt != "bf16" else
                          "torch._grouped_mm missing from this torch")
    return row


def _int8pack_mm_ms(x, w, want) -> dict:
    """The yardstick of an int8 dense product: one
    ``torch._weight_int8pack_mm`` call (x times the [N, K] int8 weight
    and its per-channel scales) where this torch has a CUDA kernel for
    it, else none and why.  The port never calls it."""
    name = "torch._weight_int8pack_mm"
    if not hasattr(torch, "_weight_int8pack_mm"):
        return {"library": f"none: {name} missing from this torch"}
    wt = w.q.t().contiguous()
    try:
        ref = torch._weight_int8pack_mm(x, wt, w.s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return {"library": f"none: {name} has no CUDA kernel here "
                           f"({str(exc).splitlines()[0][:160]})"}
    return {"library": name,
            "library_max_abs_diff": float((ref.float() - want.float())
                                          .abs().max()),
            "library_ms": time_ms(lambda: torch._weight_int8pack_mm(
                x, wt, w.s))}


# inner k tiles of the tinygemm int4 layout (its kernel's widest)
INT4PACK_INNER_K_TILES = 8


def _int4pack_mm_ms(x, w, want) -> dict:
    """The yardstick of an int4 dense product: one
    ``torch._weight_int4pack_mm`` call (tinygemm's kernel: x times
    ``(u - 8) * s + z`` for the unsigned nibbles ``u``, group scales ``s``
    and zero points ``z``) on the QTensor4 repacked once, with ``u = q +
    8`` and ``z = 0``, so it computes ``x @ (q * s)``, the same function,
    where this torch has a CUDA kernel for it, else none and why.  The
    port never calls it."""
    from crowdllama_tpu_torch.ops.quant import unpack_int4

    name = "torch._weight_int4pack_mm"
    if not (hasattr(torch, "_weight_int4pack_mm")
            and hasattr(torch, "_convert_weight_to_int4pack")):
        return {"library": f"none: {name} missing from this torch"}
    u = (unpack_int4(w.q).to(torch.int32) + 8).t().contiguous()  # [N, K]
    zeros = torch.zeros_like(w.s)
    sz = torch.stack((w.s, zeros), dim=-1).contiguous()  # [K/g, N, 2]
    group = w.group
    # This torch's packing takes nibble pairs in uint8 [N, K / 2] (torch
    # 2.5 on) or the values in int32 [N, K] (before).
    errors = []
    for packed in (((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), u):
        try:
            wp = torch._convert_weight_to_int4pack(packed,
                                                   INT4PACK_INNER_K_TILES)
            ref = torch._weight_int4pack_mm(x, wp, group, sz)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as exc:
            errors.append(str(exc).splitlines()[0][:120])
            continue
        return {"library": name,
                "library_max_abs_diff": float((ref.float() - want.float())
                                              .abs().max()),
                "library_ms": time_ms(lambda: torch._weight_int4pack_mm(
                    x, wp, group, sz))}
    return {"library": f"none: {name} has no CUDA kernel here "
                       f"({'; '.join(errors)})"}


def _spread(gen_cpu: torch.Generator, rows: int, experts: int) -> list[int]:
    """Group sizes of ``rows`` routed at random (some experts may get
    none)."""
    ids = torch.randint(0, experts, (rows,), generator=gen_cpu)
    return torch.bincount(ids, minlength=experts).tolist()


def gemm_phase(dev) -> dict:
    """Kernel G in bf16, int8 and int4 against its plain version at
    Mixtral's decode shapes (8 experts, 2 rows a token at 1, 8 and 64
    tokens, hidden 4096 -> 14336 and back, the rows spread at random, and
    all 16 rows of 8 tokens on one expert), one prefill of 1,024 tokens,
    and llama-3-8b's dense products (E 1, 8 and 512 rows).  Emits the
    ``kernel_G`` line; returns each format's row at ``GEMM_ROW_CASE``
    and its worst error."""
    gen = torch.Generator(device=dev).manual_seed(0)
    gen_cpu = torch.Generator().manual_seed(0)
    cases: dict[str, dict] = {}
    plans = []
    for slots in GEMM_DECODE_SLOTS:
        plans.append((f"decode{slots}", _spread(gen_cpu, 2 * slots, MIX_E)))
    plans.append(("decode8_one_expert", [16] + [0] * (MIX_E - 1)))
    plans.append(("prefill", _spread(gen_cpu, 2 * GEMM_PREFILL_TOKENS,
                                     MIX_E)))
    for fmt in GEMM_FORMATS:
        out = cases[fmt] = {}
        for direction, (k, n) in (("gate", (MIX_D, MIX_F)),
                                  ("down", (MIX_F, MIX_D))):
            w = _bank(dev, gen, fmt, MIX_E, k, n)
            for name, sizes in plans:
                out[f"{name}_{direction}"] = dict(
                    check_gemm(dev, gen, w, fmt, sizes, sum(sizes)),
                    sizes=sizes)
            del w
            _free_card()
        for m, k, n in GEMM_DENSE:
            w = _bank(dev, gen, fmt, 1, k, n)
            out[f"dense_m{m}_{k}x{n}"] = check_gemm(dev, gen, w, fmt, None, m)
            del w
        _free_card()
    from crowdllama_tpu_torch.ops import cuda as kernels
    from crowdllama_tpu_torch.ops.cuda.gemm import STREAM_BLOCKS_PER_SM

    resources = {sym + sfx: kernels.kernel_resources("grouped_gemm",
                                                     sym + sfx, 0, 0, dev)
                 for sym in kernels.SIGNATURES["grouped_gemm"]
                 for sfx in ("", "_stream")}
    # The streaming plan's wave is the build's occupancy.
    for fmt, sym in zip(GEMM_FORMATS, kernels.SIGNATURES["grouped_gemm"]):
        held = resources[sym + "_stream"]["blocks_per_sm"]
        if held != STREAM_BLOCKS_PER_SM[fmt]:
            raise AssertionError(f"G {fmt}: the streaming kernel holds {held} "
                                 f"blocks an SM, the plan assumes "
                                 f"{STREAM_BLOCKS_PER_SM[fmt]}")
    emit({"phase": "kernel_G", "rtol_of_scale": GEMM_RTOL,
          "grouped_mm_available": hasattr(torch, "_grouped_mm"),
          "resources": resources,
          "cases": cases, "card": torch.cuda.get_device_name(0)})
    return {fmt: dict(cases[fmt][GEMM_ROW_CASE],
                      max_abs_err=max(c["max_abs_err"]
                                      for c in cases[fmt].values()))
            for fmt in GEMM_FORMATS}


def _zero_eos(runner) -> None:
    """Zero the EOS column of every rank's unembedding that holds it (its
    value, or its nibble, in a quantized one), so no random-weight stream
    stops early."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.ops.quant import QTensor, QTensor4

    col = ByteTokenizer.EOS
    for p in runner.params:
        head = p["lm_head"]
        width = head.shape[-1]
        if col < width:
            if isinstance(head, QTensor4):  # keep the byte's other nibble
                byte = head.q[:, col // 2].to(torch.int16)
                keep = (byte >> 4) << 4 if col % 2 == 0 else byte & 0xF
                head.q[:, col // 2] = keep.to(torch.int8)
            elif isinstance(head, QTensor):
                head.q[:, col] = 0
            else:
                head[:, col] = 0
            return
        col -= width


def moe_live_params(dev, layers: int, quantize: str = "int8") -> tuple:
    """Mixtral cut to ``layers`` layers at full width on permutation
    weights (``testing/modelgen.py``) with attention and experts kept live:
    ``wo`` and ``w_down`` random at 0.45 / sqrt(fan_in * hidden) instead of
    zero (each moves the residual stream by ~0.2 of a unit embedding, as
    the CPU tests' tiny checkpoint), so greedy decode keeps O(1) margins
    while every expert reaches the logits; quantized on the card.
    Returns (config, params)."""
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.ops.quant import quantize_params
    from crowdllama_tpu_torch.testing.modelgen import permutation_params

    cfg = get_config(MIXTRAL, num_layers=layers,
                     max_context_length=MOE_CONTEXT)
    params = permutation_params(cfg, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for name in ("wo", "w_down"):
        w = params["layers"][name]
        fan_in = w.shape[-2]
        w.copy_((torch.randn(w.shape, generator=gen, device=dev)
                 * (0.45 / (fan_in * cfg.hidden_size) ** 0.5)).to(w.dtype))
    return cfg, quantize_params(params, mode=quantize, device=dev)


def moe_cut_phase(dev, phase: str, ran: set[str], layers: int,
                  quantize: str, params=None, cfg=None, **engine_kw) -> dict:
    """Mixtral at full width cut to ``layers`` layers (random seed-0
    weights made by the runner, or ``params``): 2 greedy short prompts and
    the long one, 16 tokens; the kernels in ``ran`` launch and no other;
    the step logits through the kernels agree with the plain route (2% of
    the scale under tp, else 5%); the steady step.  Returns the launches,
    the streams' token ids and the line."""
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    if cfg is None:
        cfg = get_config(MIXTRAL, num_layers=layers,
                         max_context_length=MOE_CONTEXT)
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1")}, MOE_TOKENS,
        params=params, random_init=params is None, model=MIXTRAL,
        model_config=cfg, quantize=quantize, **engine_kw)
    del params
    tp = int(engine_kw.get("mesh_shape") or 1)
    _expect_launches(summary["launches"], ran, phase)
    out = {}
    if tp > 1:
        out["decode_steps"] = _expect_tp_launches(
            summary["launches"], tp, False, phase, layers)
    if reqs["long"]["prompt_tokens"] <= engine.runner.ragged_chunk \
            or engine.scheduler.ragged_chunks < 1:
        raise AssertionError(f"{phase}: the long prompt took no ragged chunk")
    errs = logits_check(engine, dev)
    rtol = LOGIT_RTOL_TP if tp > 1 else LOGIT_RTOL
    for k, e in errs.items():
        if not e["max_abs_err"] <= rtol * e["scale"]:
            raise AssertionError(f"{phase} {k} logits: kernel vs plain {e}")
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp,
                                gemm=True)
    kw = {k: [str(d) for d in v] if k == "devices" else v
          for k, v in engine_kw.items()}
    line = {"phase": phase, "model": MIXTRAL, "layers": cfg.num_layers,
            "quantize": quantize or "bf16",
            "reduced": {"num_layers": [32, cfg.num_layers],
                        "max_context_length": [32768, MOE_CONTEXT]},
            **kw, **summary, **out, "logits_max_abs_err": errs,
            "logits_rtol": rtol, "steady_decode": steady,
            "card": torch.cuda.get_device_name(0)}
    return summary["launches"], {k: v["ids"] for k, v in reqs.items()}, line


def moe_phase(dev) -> dict:
    """mixtral-8x7b at full width and depth (32 layers, 8 experts, top 2,
    hidden 4096, expert width 14336) with int8 weights: the runner makes
    seed-0 weights born quantized on the card (``random_quantized_params``,
    ~47 GB; the 93 GB bf16 tree never exists), paged bf16 KV,
    context clamped to 2,048, ``megastep_k=4``.  The paged phase's traffic
    (6 short greedy prompts, a prefix hit, the long prompt through ragged
    chunks) served eagerly, 16 tokens: A, B, C and G (int8) launch and no
    other; then 2 prompts under a page served eagerly and as megastep
    flights on the same engine: token-identical (the MoE forward runs in
    a captured graph, so it is free of host syncs); the last-position
    logits of a prefill, a decode step and a ragged step through the
    kernels against the plain route (``LOGIT_RTOL``); the steady decode
    step with all slots live beside its bound (every weight byte once at
    3.35 TB/s), and G's share of it; peak memory.  Then, cut in depth:
    bf16 weights at 4 layers (G on bf16 banks), int4 at 8 layers, and
    tp=2 int8 at 2 layers on one card (F, G per rank) against tp=1 on the
    same live permutation weights, token for token.  Returns the G rows'
    launches by format."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    streams = {**GREEDY, "prefix_hit": (HIT, {})}
    pair = {k: GREEDY[k] for k in ("short2", "short5")}

    async def go():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        memory = {"before_start": torch.cuda.memory_allocated(dev)}
        engine = TorchEngine(model=MIXTRAL, quantize="int8", device=dev,
                             max_context_length=MOE_CONTEXT,
                             megastep_k=MOE_K, decode_chunk=MOE_K)
        t0 = time.perf_counter()
        await engine.start()
        start_s = time.perf_counter() - t0
        _zero_eos(engine.runner)
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        r = engine.runner
        memory.update(start_peak=torch.cuda.max_memory_allocated(dev),
                      after_start=torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            engine.scheduler._megastep = False
            _zero_launches()
            served = await serve(engine, streams, MOE_TOKENS)
            launches = _launches()
            hits = r.prefix_hits
            eager = await _serve_ids(engine, pair, MOE_TOKENS)
            engine.scheduler._megastep = True
            replays0 = sum(g.replays for g in r._graphs._graphs.values())
            mega = await _serve_ids(engine, pair, MOE_TOKENS)
            replays = sum(g.replays for g in r._graphs._graphs.values()) \
                - replays0
            memory["serve_peak"] = torch.cuda.max_memory_allocated(dev)
        finally:
            await engine.stop()
        return engine, start_s, served, launches, hits, eager, mega, \
            replays, memory

    engine, start_s, served, launches, hits, eager, mega, replays, memory = \
        asyncio.run(go())
    reqs = served["requests"]
    for name, v in reqs.items():
        if not (v["done"] and v["completion_tokens"] == MOE_TOKENS):
            raise AssertionError(f"moe: stream {name} ended {v}")
    _expect_launches(launches, {"A", "B", "C", "G_int8"}, "moe")
    if hits < 1 or engine.scheduler.ragged_chunks < 1:
        raise AssertionError(f"moe: prefix hits {hits}, ragged chunks "
                             f"{engine.scheduler.ragged_chunks}")
    if mega != eager or replays < 1:
        raise AssertionError(f"moe: megastep streams {mega} (replays "
                             f"{replays}) differ from eager {eager}")
    errs = _check_logit_errs(logits_check(engine, dev), "moe")
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp,
                                gemm=True)
    r = engine.runner
    weight_bytes = _step_weight_bytes(r)
    tokens = sum(v["completion_tokens"] for v in reqs.values())
    ttft = sorted(v["ttft_ms"] for v in reqs.values())
    moe_line = {
        "phase": "moe", "model": MIXTRAL, "layers": r.cfg.num_layers,
        "quantize": "int8", "experts": [r.cfg.num_experts,
                                        r.cfg.num_experts_per_tok],
        "reduced": {"max_context_length": [32768, MOE_CONTEXT]},
        "start_s": start_s, "wall_s": served["wall_s"],
        "completion_tokens": tokens,
        "tokens_per_s": tokens / served["wall_s"],
        "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
        "long_ttft_ms": reqs["long"]["ttft_ms"], "prefix_hits": hits,
        "ragged_chunks": engine.scheduler.ragged_chunks,
        "launches": launches, "memory": memory,
        "max_memory_allocated": max(memory["start_peak"],
                                    memory["serve_peak"]),
        "weight_bytes": weight_bytes,
        "megastep": {"k": MOE_K, "streams": len(pair), "tokens": MOE_TOKENS,
                     "graph_replays": replays,
                     "graph_captures": r._graphs.captures,
                     "capture_s": r._graphs.capture_s,
                     "token_identical_to_eager": True},
        "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL,
        "steady_decode": steady,
        "steady_bound_ms": weight_bytes / PEAK_BYTES * 1e3,
        "card": torch.cuda.get_device_name(0)}
    del engine, r
    _free_card()
    emit(moe_line)
    counts = {"G_int8": launches["G_int8"]}
    lines = []
    got, _, line = moe_cut_phase(dev, "moe_bf16", {"A", "B", "C", "G"},
                                 MOE_BF16_LAYERS, "")
    counts["G"] = got["G"]
    lines.append(line)
    _free_card()
    got, _, line = moe_cut_phase(dev, "moe_int4", {"A", "B", "C", "G_int4"},
                                 MOE_INT4_LAYERS, "int4")
    counts["G_int4"] = got["G_int4"]
    lines.append(line)
    _free_card()
    cfg, params = moe_live_params(dev, MOE_TP_LAYERS)
    _, one, line1 = moe_cut_phase(dev, "moe_tp1", {"A", "B", "C", "G_int8"},
                                  MOE_TP_LAYERS, "int8", params=params,
                                  cfg=cfg)
    _free_card()
    _, two, line2 = moe_cut_phase(dev, "moe_tp2", {"A", "C", "F", "G_int8"},
                                  MOE_TP_LAYERS, "int8", params=params,
                                  cfg=cfg, mesh_shape="2",
                                  devices=[dev, dev])
    del params
    if one != two:
        raise AssertionError(f"moe_tp2: streams {two} differ from tp=1's "
                             f"{one}")
    line2["token_identical_to_tp1"] = True
    lines += [line1, line2]
    for line in lines:
        emit(line)
    _free_card()
    return counts


def _step_weight_bytes(runner) -> int:
    """Bytes of the weights a decode step reads whole (every leaf but the
    embedding table, of which it gathers a row a slot; a quantized leaf's
    values and scales), over every rank."""
    def leaves(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v)
            elif k != "embed":
                yield v

    return sum(nbytes(v.q, v.s) if hasattr(v, "q") else nbytes(v)
               for p in runner.params for v in leaves(p))


def quant_phase(dev, bf16_steady: dict) -> None:
    """llama-3-8b at full width and depth (32 layers) with int8 and then
    int4 weights (born quantized on the card: ``random_quantized_params``),
    the paged phase's traffic, 16 tokens: A, B, C and G launch (its int8
    or int4 entry) and no other; prefill, decode and ragged step logits
    through the kernels against the plain route; the steady step and G's
    share of it beside the bf16 phase's step (``engine_llama``)."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    out = {}
    for mode in ("int8", "int4"):
        engine, summary, reqs = run_engine(
            dev, {**GREEDY, "prefix_hit": (HIT, {})}, MOE_TOKENS,
            random_init=True, model=LLAMA, quantize=mode)
        _expect_launches(summary["launches"],
                         {"A", "B", "C", GEMM_ROW[mode]}, f"quant_{mode}")
        if summary["prefix_hits"] < 1 or engine.scheduler.ragged_chunks < 1:
            raise AssertionError(f"quant_{mode}: a path was not taken")
        errs = _check_logit_errs(logits_check(engine, dev), f"quant_{mode}")
        steady = decode_step_timing(engine, dev,
                                    flash_paged_decode_attention_tp,
                                    gemm=True)
        weight_bytes = _step_weight_bytes(engine.runner)
        out[mode] = {**summary, "logits_max_abs_err": errs,
                     "steady_decode": steady, "weight_bytes": weight_bytes,
                     "steady_bound_ms": weight_bytes / PEAK_BYTES * 1e3}
        layers = engine.runner.cfg.num_layers
        del engine
        _free_card()
    emit({"phase": "quant", "model": LLAMA, "layers": layers,
          **out, "bf16_steady_decode": bf16_steady,
          "logits_rtol": LOGIT_RTOL, "card": torch.cuda.get_device_name(0)})


# --------------------------------------------- sharded serving across workers

SHARD_PP_MODEL = "gemma-2-27b"
SHARD_PP_LAYERS = 8        # of 46: two stages of 4
SHARD_EP_LAYERS = 4        # of Mixtral's 32, over two banks of 4 experts
SHARD_CONTEXT = 8192
SHARD_TOKENS = 16
SHARD_ECHO = ECHO["echo0"][0]


def _shard_intervals():
    """Discovery and metadata cadences short enough that a group forms in
    seconds (the CPU tests' test-mode values)."""
    from crowdllama_tpu_torch.config import Intervals

    return dataclasses.replace(
        Intervals(), discovery=2.0, advertise=0.5, metadata_publish=1.0,
        metadata_refresh=5.0, health_check=5.0, dht_provider_check=2.0,
        backoff_base=0.5)


def _zero_eos_params(params: dict) -> None:
    """Zero the EOS unembedding column (the embedding row when tied), so
    no random-weight stream stops early."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer

    if "lm_head" in params:
        params["lm_head"][:, ByteTokenizer.EOS] = 0
    else:
        params["embed"][ByteTokenizer.EOS] = 0


def _tree_bytes(*trees) -> int:
    n = 0
    for tree in trees:
        for v in tree.values():
            n += _tree_bytes(v) if isinstance(v, dict) else (
                v.numel() * v.element_size())
    return n


def _span_ms(spans: list) -> float:
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans)


def shard_phase(dev, strategy: str) -> dict:
    """Sharded serving across workers (``engine/sharded.py``) on the card,
    every module the port's own, on 127.0.0.1: a DHT node, a two-member
    shard group (each member a ``ShardedEngine`` behind its own ``Peer``,
    its share drawn on the card from seed 0 piece by piece, never the
    whole tree), a consumer ``Peer`` and its ``Gateway``.

    ``pp`` (``shard_pp``): gemma-2-27b at full width (hidden 4608, 32 / 16
    heads, Dh 128, FFN 36864, vocab 256,128; softcap 50, alternating
    4,096-token windows sliced by global layer index, query scale
    144^-0.5, final softcap 30) cut to 8 of 46 layers, two stages of 4:
    prefill through kernel A, decode through kernel D in every stage.
    ``ep`` (``shard_ep``): mixtral-8x7b in bf16 at full width cut to 4 of
    32 layers, two banks of 4 experts (the leader also holds attention,
    the router and the KV): A and D on the leader, the banks' products on
    kernel G (bf16).

    Traffic: two greedy ``/api/chat`` of 16 tokens, whole and streamed
    (launch counts zeroed right before, read right after: A and D, and G
    for ep, launch, no other); for pp, one n-gram verify chat on an echo
    prompt (tokens per round trip).  After every request no member holds a
    session.  Checks: the leader's last-position logits of one prompt
    against one unsharded forward of the same weights on the card, and
    the kernel route against the plain route (the stages' or the leader's
    ``prefill_attn`` / ``decode_attn`` seams, G's plain version; for ep
    the plain route replays the kernel route's expert choices and the
    flips are counted), each within ``LOGIT_RTOL`` of the logits' scale.
    Reports: TTFT, ms per decode token split into the members' device time
    (CUDA events around each stage call or bank call and around the
    leader's own steps), the unembedding's (it widens the vocab matrix to
    fp32 at every call) and the rest (wire and host); launches per token;
    each member's start time, bytes held and start peak, and the serving
    peak of the process."""
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import FakeEngine
    from crowdllama_tpu_torch.engine.sharded import ShardedEngine
    from crowdllama_tpu_torch.engine.weights import init_params_slice
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.ops.attention import (
        decode_attention_ref,
        prefill_attention_ref,
    )
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

    phase = f"shard_{strategy}"
    pp = strategy == "pp"
    model = SHARD_PP_MODEL if pp else MIXTRAL
    layers = SHARD_PP_LAYERS if pp else SHARD_EP_LAYERS
    cfg = get_config(model, num_layers=layers,
                     max_context_length=SHARD_CONTEXT)
    group = f"{model}/{strategy}2"
    ran = {"A", "D"} if pp else {"A", "D", "G"}

    def key():
        return Ed25519PrivateKey.generate()

    async def chat(gw, prompt: str, stream: bool) -> dict:
        body = {"model": model, "stream": stream,
                "messages": [{"role": "user", "content": prompt}],
                "options": {"num_predict": SHARD_TOKENS}}
        r = await asyncio.to_thread(_http, gw.port, "POST", "/api/chat",
                                    body)
        if r["status"] != 200:
            raise AssertionError(f"{phase}: /api/chat {r['status']}: "
                                 f"{r['lines']}")
        frames = _ndjson(r)
        if not frames[-1].get("done"):
            raise AssertionError(f"{phase}: stream not done: {frames[-1]}")
        return {"t0": r["t0"], "frames": len(frames),
                "eval_count": frames[-1].get("eval_count", 0)}

    async def go() -> dict:
        boot, _ = await new_host_and_dht(key(), listen_host="127.0.0.1")
        node = dict(listen_host="127.0.0.1",
                    bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"],
                    intervals=_shard_intervals())
        started: list = []
        out: dict = {"phase": phase, "model": model, "strategy": strategy,
                     "reduced": {"num_layers": [layers, get_config(
                         model).num_layers]},
                     "context": SHARD_CONTEXT}
        try:
            engines, peers, members = [], [], []
            for index in (0, 1):
                conf = Configuration(
                    model=model, shard_group=group, shard_index=index,
                    shard_count=2, shard_strategy=strategy,
                    max_context_length=SHARD_CONTEXT, **node)
                eng = ShardedEngine(conf, device=dev, model_config=cfg)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                await eng.start()
                torch.cuda.synchronize()
                members.append({
                    "index": index, "start_s": time.perf_counter() - t0,
                    "held_gb": (torch.cuda.memory_allocated() - base) / 1e9,
                    "start_peak_gb": (torch.cuda.max_memory_allocated()
                                      - base) / 1e9})
                started.append(eng)
                peer = Peer(key(), conf, eng)
                await peer.start()
                started.append(peer)
                engines.append(eng)
                peers.append(peer)
            leader, member = engines
            if pp:
                _zero_eos_params(leader._embed_params)
                shares = [dict(leader.runner.layers, **leader._embed_params),
                          member.runner.layers]
            else:
                _zero_eos_params(leader.runner.embed_params)
                shares = [dict(leader.runner.layers,
                               **leader.runner.embed_params,
                               wg=leader.bank.wg, wu=leader.bank.wu,
                               wd=leader.bank.wd),
                          dict(wg=member.bank.wg, wu=member.bank.wu,
                               wd=member.bank.wd)]
            for m, share in zip(members, shares):
                m["weights_gb"] = _tree_bytes(share) / 1e9
            if not pp:
                out["expert_ids"] = [leader.expert_ids, member.expert_ids]
            consumer = Peer(key(), Configuration(**node),
                            FakeEngine(models=[]), worker_mode=False)
            await consumer.start()
            started.append(consumer)
            gw = Gateway(consumer, port=0, host="127.0.0.1")
            await gw.start()
            started.append(gw)
            pm = consumer.peer_manager
            t0 = time.perf_counter()
            while not ((best := pm.find_best_worker(model)) is not None
                       and best.peer_id == peers[0].peer_id
                       and peers[1].peer_id in {
                           p.peer_id for p in
                           peers[0].peer_manager.group_members(group)}):
                if time.perf_counter() - t0 > 120:
                    raise AssertionError(f"{phase}: group not routable")
                await asyncio.sleep(0.1)
            out["group_routable_s"] = time.perf_counter() - t0
            pipe = await leader._resolve_pipeline()

            # CUDA events around the members' device work.
            spans = {"member": [], "leader": [], "unembed": []}
            if pp:
                for who, eng in (("leader", leader), ("member", member)):
                    eng.runner.decode = _event_timed(eng.runner.decode,
                                                     spans[who])
                pipe._unembed = _event_timed(pipe._unembed,
                                             spans["unembed"])
            else:
                r = leader.runner
                r.decode_layer = _event_timed(r.decode_layer,
                                              spans["leader"])
                r.unembed = _event_timed(r.unembed, spans["unembed"])
                leader.bank._ffn = _event_timed(leader.bank._ffn,
                                                spans["leader"])
                member.bank._ffn = _event_timed(member.bank._ffn,
                                                spans["member"])

            def sessions() -> int:
                n = leader.runner.session_count
                return n + (member.runner.session_count if pp else 0)

            marks: list = []

            def decode_only() -> None:
                # A stream's first token: its prefill's spans go, and the
                # launch counts so far are its prefill's.
                for v in spans.values():
                    v.clear()
                marks.append(_launches())

            tok = _StreamLog(leader.tokenizer, decode_only)
            leader.tokenizer = tok
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            chats = []
            dev_total = dict.fromkeys(spans, 0.0)
            decode_launches = dict.fromkeys(ran, 0)
            unembeds = 0
            for prompt, stream in ((SHORT[0], False), (SHORT[1], True)):
                c = await chat(gw, prompt, stream)
                now = _launches()
                for k in ran:
                    decode_launches[k] += now[k] - marks[-1][k]
                if sessions():
                    raise AssertionError(f"{phase}: {sessions()} sessions "
                                         "left after a request")
                for k, v in spans.items():
                    dev_total[k] += _span_ms(v)
                unembeds += len(spans["unembed"])
                times = [t for t, _ in tok.streams[-1]]
                c.update(tokens=len(times), ttft_ms=(times[0] - c["t0"]) * 1e3,
                         decode_ms_per_token=(times[-1] - times[0]) * 1e3
                         / max(1, len(times) - 1))
                chats.append(c)
            tok.on_first = None
            launches = _launches()
            _expect_launches(launches, ran, phase)
            decode_tokens = sum(c["tokens"] - 1 for c in chats)
            tokens = sum(c["tokens"] for c in chats)
            if any(c["eval_count"] != SHARD_TOKENS for c in chats):
                raise AssertionError(f"{phase}: chats {chats}")
            dev_ms = {k: v / decode_tokens for k, v in dev_total.items()}
            out["unembed_ms_per_call"] = dev_total["unembed"] / max(1, unembeds)
            v, d = cfg.vocab_size, cfg.hidden_size
            out["unembed_fp32_copy_gb"] = v * d * 4 / 1e9
            per_token = sum(c["decode_ms_per_token"] * (c["tokens"] - 1)
                            for c in chats) / decode_tokens
            out["chats"] = chats
            out["ttft_ms"] = [c["ttft_ms"] for c in chats]
            out["decode_ms_per_token"] = per_token
            out["device_ms_per_token"] = dev_ms
            out["rest_ms_per_token"] = per_token - sum(dev_ms.values())
            out["launches"] = {k: launches[k] for k in sorted(ran)}
            out["launches_per_decode_token"] = {
                k: decode_launches[k] / decode_tokens for k in sorted(ran)}
            out["launches_per_prefill"] = {
                k: (launches[k] - decode_launches[k]) / len(chats)
                for k in sorted(ran)}
            out["tokens"] = tokens
            # Both members share this process and the card.
            out["serving_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["serving_peak_above_weights_gb"] = (
                torch.cuda.max_memory_allocated() - base) / 1e9
            out["members"] = members
            if pp:
                # n-gram speculation on an echo prompt: one verify round
                # trip per window (plain prefix-context attention).
                leader.config.spec_decode = "ngram"
                try:
                    c = await chat(gw, SHARD_ECHO, True)
                finally:
                    leader.config.spec_decode = ""
                if sessions():
                    raise AssertionError(f"{phase}: sessions left after "
                                         "the verify chat")
                out["ngram"] = dict(leader.describe()["spec_decode"],
                                    eval_count=c["eval_count"])
            counts = _launches()

            # The checks (their launches are not the path's).
            ids = leader.tokenizer.encode(SHORT[2])
            bucket = 16
            while bucket < len(ids):
                bucket *= 2

            async def route(plain: bool, routing=None) -> list:
                runners = ([leader.runner, member.runner] if pp
                           else [leader.runner])
                swaps = contextlib.ExitStack()
                if plain:
                    for rn in runners:
                        swaps.enter_context(_swapped(
                            rn, "prefill_attn", prefill_attention_ref))
                        swaps.enter_context(_swapped(
                            rn, "decode_attn", decode_attention_ref))
                    swaps.enter_context(_plain_products())
                if routing is not None:
                    swaps.enter_context(routing.plain() if plain
                                        else routing.kernel())
                with swaps:
                    first = await pipe.prefill("check", ids, bucket)
                    step = await pipe.decode("check", int(first.argmax()),
                                             len(ids), len(ids) + 1)
                    await pipe.release("check")
                return [torch.from_numpy(first), torch.from_numpy(step)]

            routing = _Routing(not pp)
            kernel = await route(False, routing)
            plain = await route(True, routing)
            errs = {"prefill": _logit_err(kernel[0], plain[0]),
                    "decode": _logit_err(kernel[1], plain[1])}
            errs["prefill"] = routing.report(errs["prefill"])
            out["kernel_vs_plain"] = _check_logit_errs(errs, phase)

            full = init_params_slice(cfg, 0, device=dev)
            _zero_eos_params(full)
            tokens_t = torch.tensor([ids], device=dev)
            pos = torch.arange(len(ids), device=dev,
                               dtype=torch.int32)[None]
            with torch.inference_mode():
                want, _, _ = T.prefill([full], cfg, tokens_t, pos)
            want = want[0, -1].float().cpu()
            del full
            _free_card()
            out["vs_unsharded"] = _check_logit_errs(
                {"prefill": _logit_err(kernel[0], want)}, phase)
            if sessions():
                raise AssertionError(f"{phase}: sessions left after checks")
            out["check_launches"] = {k: _launches()[k] - counts[k]
                                     for k in sorted(ran)}
            out["sessions_left"] = sessions()
            _set_launches(counts)
            return out
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()

    line = asyncio.run(go())
    emit(line)
    _free_card()
    return line


MESH_TOKENS = 16
MESH_K = 4  # the mesh_pp megastep flight
# TinyLlama at full width cut in depth (``reduced`` on each line): the
# mesh phases check the sharded math and the launches, which the depth
# only multiplies, and the cut keeps the script inside its limit.
MESH_LAYERS = 8
_ML = MESH_LAYERS
# (phase, mesh spec, engine keywords, kernels that launch, A launches a
# monolithic prefill, D launches a decode step) for TinyLlama (MESH_LAYERS
# layers, 8 slots: pp takes 2 microbatches of 4).
MESH_PHASES = (
    ("mesh_tp_contig", "2", dict(kv_layout="contiguous"), {"A", "D"},
     _ML * 2, _ML * 2),
    ("mesh_dp", "2x1", {}, {"A", "D"}, _ML, _ML * 2),
    ("mesh_pp", "1x2x1x1x1", {}, {"A", "D"}, _ML, _ML * 2),
    ("mesh_sp", "1x2x1x1", {}, set(), 0, 0),
    ("mesh_pp_tp", "1x2x1x1x2", {}, {"A", "D"}, _ML * 2, _ML * 4),
)
MESH_EP_LAYERS = 2


def _mesh_streams() -> dict:
    return {k: GREEDY[k] for k in ("short0", "short1")}


def _mesh_model(dev) -> dict:
    """run_engine's keywords for TinyLlama cut to MESH_LAYERS layers: the
    seed-0 weights' first layers and the cut config."""
    from crowdllama_tpu_torch.models.config import get_config

    return dict(params=_cut(seed0_params(dev), MESH_LAYERS),
                model_config=get_config(TINYLLAMA, num_layers=MESH_LAYERS))


def _mesh_decode_logits(r, tok, plain: bool) -> tuple:
    """3 slots prefilled and one decode step, through kernels A and D (per
    rank) or, with ``plain``, through their plain versions: (logits of the
    3 live rows on the host, their first tokens)."""
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import decode_attention_plain

    seams = r.prefill_attn, r.decode_attn
    if plain:
        r.prefill_attn, r.decode_attn = (prefill_attention_ref,
                                         decode_attention_plain)
    try:
        with torch.inference_mode():
            st = _three_slots(r, tok)
            first = st.tokens[:3].cpu().tolist()
            logits = r.decode_logits(st)[:3].float().cpu()
    finally:
        r.prefill_attn, r.decode_attn = seams
    return logits, first


def mesh_base_phase(dev) -> dict:
    """TinyLlama on one device with the contiguous layout, the mesh
    phases' traffic: the line every mesh line stands beside."""
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention

    engine, summary, reqs = run_engine(dev, _mesh_streams(), MESH_TOKENS,
                                       kv_layout="contiguous",
                                       **_mesh_model(dev))
    _expect_launches(summary["launches"], {"A", "D"}, "mesh_base")
    logits, first = _mesh_decode_logits(engine.runner, engine.tokenizer,
                                        plain=True)
    steady = decode_step_timing(engine, dev, flash_decode_attention)
    emit({"phase": "mesh_base", "model": TINYLLAMA, "layers": MESH_LAYERS,
          "reduced": {"num_layers": [22, MESH_LAYERS]},
          "kv_layout": "contiguous", **summary, "steady_decode": steady,
          "card": nvidia_smi()})
    return {"ids": {k: v["ids"] for k, v in reqs.items()},
            "steady": steady, "ttft_ms_median": summary["ttft_ms_median"],
            "max_memory_allocated": summary["max_memory_allocated"],
            "logits": logits, "first": first}


def mesh_megastep_check(r, tok) -> dict:
    """One K-step megastep flight on the mesh runner (a CUDA graph captured
    on its state and replayed) against K eager steps from the same 3
    slots: the tokens must be equal."""
    with torch.inference_mode():
        st = _three_slots(r, tok)
        eager = r.decode_steps(st, MESH_K)[0][:, :3].tolist()
        st = _three_slots(r, tok)
        toks, _, st = r.decode_megastep(st, MESH_K)
        mega = toks[:, :3].cpu().tolist()
    replays = sum(g.replays for g in r._graphs._graphs.values())
    if mega != eager or replays < 1:
        raise AssertionError(f"mesh megastep flight {mega} (replays "
                             f"{replays}) differs from eager {eager}")
    return {"k": MESH_K, "replays": replays, "equal_to_eager": True}


def mesh_phase(dev, base: dict, phase: str, spec: str, engine_kw: dict,
               ran: set, a_per_prefill: int, d_per_step: int) -> dict:
    """One TinyLlama mesh, every rank on the one card: the traffic, the
    launches, the plan's move to the contiguous layout, kernel-vs-plain
    logits, the steady step and memory beside ``mesh_base``."""
    import math

    from crowdllama_tpu_torch.engine.runner import ModelRunner
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention
    from crowdllama_tpu_torch.parallel.mesh import mesh_axes

    n = math.prod(mesh_axes(spec))
    engine, summary, reqs = run_engine(
        dev, _mesh_streams(), MESH_TOKENS, mesh_shape=spec,
        devices=[dev] * n, **engine_kw, **_mesh_model(dev))
    r, plan = engine.runner, engine.plan
    if type(r) is not ModelRunner or r.kv_layout != "contiguous" \
            or r.devices != [dev] * n:
        raise AssertionError(f"{phase}: {type(r).__name__} "
                             f"{r.kv_layout} on {r.devices}")
    notes = [] if engine_kw.get("kv_layout") == "contiguous" else [
        f"paged layout does not compose with mesh {spec} (dp/sp/pp > 1); "
        f"using the contiguous layout"]
    if plan.notes != notes:
        raise AssertionError(f"{phase}: plan notes {plan.notes}")
    launches = summary["launches"]
    _expect_launches(launches, ran, phase)
    a, d = launches["A"], launches["D"]
    if ran and (a % a_per_prefill or d % d_per_step):
        raise AssertionError(f"{phase}: A {a} not a multiple of "
                             f"{a_per_prefill} a prefill or D {d} not a "
                             f"multiple of {d_per_step} a decode step")
    tok = engine.tokenizer
    kernel, first = _mesh_decode_logits(r, tok, plain=False)
    plain, _ = _mesh_decode_logits(r, tok, plain=True)
    errs = {"decode": _logit_err(kernel, plain)}
    agree = [i for i in range(3) if first[i] == base["first"][i]]
    if not agree:
        raise AssertionError(f"{phase}: no first token equals one "
                             f"device's ({first} vs {base['first']})")
    errs["vs_one_device"] = dict(
        _logit_err(kernel[agree], base["logits"][agree]), rows=agree)
    if not errs["decode"]["max_abs_err"] <= \
            LOGIT_RTOL_TP * errs["decode"]["scale"]:
        raise AssertionError(f"{phase} logits: kernel vs plain {errs}")
    if not ran and not errs["vs_one_device"]["max_abs_err"] <= \
            LOGIT_RTOL * errs["vs_one_device"]["scale"]:
        raise AssertionError(f"{phase} logits: against one device {errs}")
    out = {}
    if phase == "mesh_pp":
        out["megastep"] = mesh_megastep_check(r, tok)
    steady = decode_step_timing(engine, dev,
                                flash_decode_attention if ran else None)
    if phase in {m[-1] for m in MP_MESHES}:
        _MESH_REFS[phase] = _mesh_reference(phase, engine, summary, reqs,
                                            steady)
    peak = summary["max_memory_allocated"]
    emit({"phase": phase, "model": TINYLLAMA, "layers": MESH_LAYERS,
          "reduced": {"num_layers": [22, MESH_LAYERS]}, "mesh": spec,
          "axes": r.mesh.axes, "devices": [str(x) for x in r.devices],
          "runner": type(r).__name__, "kv_layout": r.kv_layout,
          "plan_notes": plan.notes, **summary,
          "decode_steps": d // d_per_step if ran else None,
          "prefills_through_a": a // a_per_prefill if ran else None,
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL_TP,
          "greedy_tokens_equal_to_one_device": _greedy_share(base["ids"],
                                                             reqs),
          "steady_decode": steady, "one_device_steady_decode": base["steady"],
          "one_device_ttft_ms_median": base["ttft_ms_median"],
          "one_device_max_memory_allocated": base["max_memory_allocated"],
          "memory_ratio_to_one_device": peak / base["max_memory_allocated"],
          **out, "card": nvidia_smi()})
    return launches


def _mesh_ep_model(dev) -> dict:
    """run_engine's keywords for mixtral-8x7b in bf16 cut to
    MESH_EP_LAYERS layers: seed-0 weights made on the card with the EOS
    column zeroed, kept on the host as TinyLlama's (each engine copies
    them), and the cut config."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.engine.weights import init_params
    from crowdllama_tpu_torch.models.config import get_config

    cfg = get_config(MIXTRAL, num_layers=MESH_EP_LAYERS,
                     max_context_length=MOE_CONTEXT)
    params = init_params(cfg, 0, device=dev)
    params["lm_head"][:, ByteTokenizer.EOS] = 0
    return dict(params=_host_tree(params), model_config=cfg)


def mesh_ep_phase(dev) -> dict:
    """mixtral-8x7b in bf16 at full width cut to ``MESH_EP_LAYERS`` layers
    (seed-0 weights made on the card, the EOS column zeroed, kept on the
    host), paged, on one
    device and then on ``"1x2x1"`` with both expert banks on the one card:
    2 short streams and the long one, 16 tokens; A, B, C and G launch, G
    once per ep bank per expert product; kernel-vs-plain logits (the plain
    route replaying the kernel route's expert choices); the steady step and
    memory beside one device."""
    from crowdllama_tpu_torch.engine.paged import PagedModelRunner
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )
    from crowdllama_tpu_torch.parallel.sharding import ExpertBanks

    model = _mesh_ep_model(dev)
    params, cfg = model["params"], model["model_config"]
    _free_card()
    runs = {}
    for spec in ("", "1x2x1"):
        kw = dict(mesh_shape=spec, devices=[dev, dev]) if spec else {}
        engine, summary, reqs = run_engine(
            dev, _mesh_streams(), MESH_TOKENS, params=params, model=MIXTRAL,
            model_config=cfg, **kw)
        launches = summary["launches"]
        _expect_launches(launches, {"A", "B", "C", "G"}, f"mesh_ep {spec}")
        r = engine.runner
        errs = logits_check(engine, dev)
        for k, e in errs.items():
            if not e["max_abs_err"] <= LOGIT_RTOL_TP * e["scale"]:
                raise AssertionError(f"mesh_ep {spec} {k} logits: kernel vs "
                                     f"plain {e}")
        steady = decode_step_timing(engine, dev,
                                    flash_paged_decode_attention_tp,
                                    gemm=True)
        runs[spec] = dict(summary=summary, reqs=reqs, errs=errs,
                          steady=steady)
        if spec:
            _MESH_REFS["mesh_ep"] = _mesh_reference("mesh_ep", engine,
                                                    summary, reqs, steady)
        if spec:
            if not (type(r) is PagedModelRunner and (r.ep, r.tp) == (2, 1)
                    and isinstance(r.params[0]["layers"]["w_gate"],
                                   ExpertBanks)):
                raise AssertionError(f"mesh_ep: {type(r).__name__} ep "
                                     f"{r.ep} tp {r.tp}")
            if launches["G"] % (3 * 2):
                raise AssertionError(f"mesh_ep: G {launches['G']} not 3 "
                                     f"products x 2 banks per MoE layer")
        del engine, r
        _free_card()
    del params
    one, ep = runs[""], runs["1x2x1"]
    per_step = ep["steady"]["gemm_launches_per_step"]
    if per_step != 2 * one["steady"]["gemm_launches_per_step"]:
        raise AssertionError(f"mesh_ep: {per_step} G launches a step, not "
                             f"twice one device's "
                             f"{one['steady']['gemm_launches_per_step']}")
    peak = ep["summary"]["max_memory_allocated"]
    peak1 = one["summary"]["max_memory_allocated"]
    emit({"phase": "mesh_ep", "model": MIXTRAL, "layers": MESH_EP_LAYERS,
          "mesh": "1x2x1", "axes": {"dp": 1, "pp": 1, "sp": 1, "ep": 2,
                                    "tp": 1},
          "kv_layout": "paged",
          "reduced": {"num_layers": [32, MESH_EP_LAYERS],
                      "max_context_length": [32768, MOE_CONTEXT]},
          **ep["summary"], "logits_max_abs_err": ep["errs"],
          "logits_rtol": LOGIT_RTOL_TP,
          "greedy_tokens_equal_to_one_device": _greedy_share(
              {k: v["ids"] for k, v in one["reqs"].items()}, ep["reqs"]),
          "steady_decode": ep["steady"],
          "one_device_steady_decode": one["steady"],
          "ttft_ms_median": ep["summary"]["ttft_ms_median"],
          "one_device_ttft_ms_median": one["summary"]["ttft_ms_median"],
          "one_device_max_memory_allocated": peak1,
          "memory_ratio_to_one_device": peak / peak1,
          "one_device_launches": one["summary"]["launches"],
          "card": nvidia_smi()})
    return ep["summary"]["launches"]


def mesh_phases(dev) -> tuple[dict, dict]:
    """Every mesh phase; returns the launches they add to the Dh-64 rows
    (A, D) and to the Dh-128 and G rows (A, B, C, G of mesh_ep)."""
    base = mesh_base_phase(dev)
    _free_card()
    dh64 = {"A": 0, "D": 0}
    for args in MESH_PHASES:
        got = mesh_phase(dev, base, *args)
        for k in dh64:
            dh64[k] += got[k]
        _free_card()
    return dh64, mesh_ep_phase(dev)


# ------------------------------------------------------------ multiprocess

# Every mesh below is served in one launch of the two processes (one
# torch import and one CUDA context a process for all of them), at the
# mesh phases' depth and tokens: TinyLlama cut to MESH_LAYERS (tp and dp
# once ran at full depth, 32 tokens; cut so the script keeps inside its
# limit) and mixtral-8x7b bf16 cut to MESH_EP_LAYERS.
MP_TIMEOUT_S = 600.0
MP_CHILD = "import sys, chip_smoke; chip_smoke.mp_child(*sys.argv[1:])"
# (phase, mesh spec, kv layout, kernels that launch in each process, model,
# speculation, the mesh phase whose one-process line it stands beside;
# None: the one-process engine on the same mesh, run here): two processes
# on the one card, the mesh split across them.  Speculation runs no D: the
# replicated runner keeps the draft length fixed (JAX's rule), so no
# verify step pauses to the plain decode step.
MP_MESHES = (
    ("multiprocess_tp", "1x2", "paged", {"A", "B"}, TINYLLAMA, "", None),
    ("multiprocess_dp", "2x1", "contiguous", {"A", "D"}, TINYLLAMA, "",
     "mesh_dp"),
    ("multiprocess_pp", "1x2x1x1x1", "contiguous", {"A", "D"}, TINYLLAMA,
     "", "mesh_pp"),
    ("multiprocess_sp", "1x2x1x1", "contiguous", set(), TINYLLAMA, "",
     "mesh_sp"),
    ("multiprocess_ep", "1x2x1", "paged", {"A", "B", "G"}, MIXTRAL, "",
     "mesh_ep"),
    ("multiprocess_spec_dp", "2x1", "contiguous", {"A"}, TINYLLAMA, "ngram",
     "mesh_dp"),
)
#: the mesh phases' one-process references of MP_MESHES, by phase (filled
#: by ``mesh_phase`` and ``mesh_ep_phase``)
_MESH_REFS: dict = {}


def _mp_device() -> torch.device:
    return torch.device("cuda", 0)


def _mp_config(spec: str, layout: str, coord: str = "", pid: int = -1,
               model: str = TINYLLAMA, spec_decode: str = ""):
    """The serving config of a multiprocess mesh: 8 slots, context 2,048,
    page 128 (the engine's defaults, which the mesh phases serve with);
    legacy chunked admission (the replicated runner has no ragged step, so
    the one-process reference runs without it too)."""
    from crowdllama_tpu_torch.config import Configuration

    kw = {}
    if coord:
        kw = dict(dist_coordinator=coord, dist_num_processes=2,
                  dist_process_id=pid)
    return Configuration(model=model, max_batch_slots=8,
                         max_context_length=2048, kv_page_size=128,
                         mesh_shape=spec, kv_layout=layout,
                         ragged_prefill=False, spec_decode=spec_decode, **kw)


def _mp_model(dev, model: str, cache: dict) -> dict:
    """The engine keywords of ``model``, made once a process as the mesh
    phases make them (:func:`_mesh_model`, :func:`_mesh_ep_model`)."""
    if model not in cache:
        cache[model] = (_mesh_ep_model(dev) if model == MIXTRAL
                        else _mesh_model(dev))
        _free_card()
    return cache[model]


class _PlainCheck:
    """A kernel wrapper standing in for the runner's seam: every call
    launches the kernel (and counts); the first call after ``arm()`` also
    runs the plain version on the same inputs and keeps the max |kernel -
    plain| and whether every element is within ATOL + RTOL * |plain| (with
    ``scale_rtol``: within that share of max |plain|, as the G phase
    holds G) (the plain call counts nothing; the serving path is not
    interrupted, the phase fails on the report).  ``rows(args, kwargs)``
    names the output rows the kernel writes (all by default)."""

    def __init__(self, name: str, kernel, plain,
                 scale_rtol: float | None = None, rows=None):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.scale_rtol = scale_rtol
        self.rows = rows
        self.reset()

    def reset(self) -> None:
        self.armed, self.err, self.ok = False, None, True

    def arm(self) -> None:
        self.armed = True

    def __call__(self, *a, **kw):
        out = self.kernel(*a, **kw)
        if self.armed:
            self.armed = False
            want = self.plain(*a, **kw)
            pairs = (list(zip(out, want)) if isinstance(out, list)
                     else [(out, want)])
            rows = slice(None) if self.rows is None else self.rows(a, kw)
            for g, w in pairs:
                g, w = g[rows].float(), w[rows].float()
                err = (g - w).abs()
                bound = (self.scale_rtol * w.abs().max()
                         if self.scale_rtol is not None
                         else ATOL + RTOL * w.abs())
                self.ok &= bool(torch.isfinite(g).all()
                                and (err <= bound).all())
                self.err = max(self.err or 0.0, float(err.max()))
        return out


#: kernel row -> the check that stands in for its seam
_MP_CHECK_OF = {"A": "A", "B": "B/F", "D": "D", "G": "G"}


def _group_rows(a: tuple, kw: dict) -> slice:
    """The rows kernel G writes: those of its groups (``offsets[0]`` to
    ``offsets[-1]``; an ep bank's slice of the offsets leaves the other
    banks' rows unwritten)."""
    off = kw.get("offsets", a[2] if len(a) > 2 else None)
    return slice(None) if off is None else slice(int(off[0]), int(off[-1]))


def _mp_seams() -> dict:
    """Install the kernel-vs-plain checks on the seams the runners take at
    construction (A for prefill, D for contiguous decode, B/F for paged
    decode) and on the expert products' lookup (G)."""
    from crowdllama_tpu_torch.engine import paged as paged_mod
    from crowdllama_tpu_torch.engine import runner as runner_mod
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import decode_attention_plain
    from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm_plain
    from crowdllama_tpu_torch.ops.cuda.paged import (
        paged_decode_attention_tp_plain,
    )

    checks = {
        "A": _PlainCheck("A", runner_mod.prefill_attention,
                         prefill_attention_ref),
        "B/F": _PlainCheck("B/F", paged_mod.flash_paged_decode_attention_tp,
                           paged_decode_attention_tp_plain),
        "D": _PlainCheck("D", runner_mod.decode_attention,
                         decode_attention_plain),
        "G": _PlainCheck("G", T.grouped_gemm, grouped_gemm_plain,
                         scale_rtol=GEMM_RTOL, rows=_group_rows)}
    runner_mod.prefill_attention = checks["A"]
    paged_mod.flash_paged_decode_attention_tp = checks["B/F"]
    runner_mod.decode_attention = checks["D"]
    T.grouped_gemm = checks["G"]
    return checks


MP_LOGITS_PROMPT = ("A prompt no stream sent, prefilled whole for the "
                    "logits check. " + SHORT[1])


def _mp_prefill_logits(runner, tok, state) -> torch.Tensor:
    """The last-row logits of a monolithic prefill of ``MP_LOGITS_PROMPT``
    (the sampler's input, caught at ``_sample_first``; a replicated
    runner frames the call, so every process runs it).  ``state`` is a
    live state, as the scheduler passes one: a follower replays PREFILL
    with its own, so a prefix lookup must happen on both sides."""
    inner = getattr(runner, "inner", runner)
    seen = []
    real = inner._sample_first

    def catch(logits, *a, **kw):
        seen.append(logits.float().cpu())
        return real(logits, *a, **kw)

    inner._sample_first = catch
    try:
        with torch.inference_mode():
            runner.prefill(tok.encode(MP_LOGITS_PROMPT), 0.0, 1.0, None,
                           state=state)
    finally:
        del inner._sample_first
    return seen[0]


def _mp_step_timing(engine, dev) -> dict:
    """Steady decode on the leader with all 8 slots live, through the
    replicated runner (every call framed): host ms a step (a verify step
    under speculation, ending in a synchronize), and the frame headers'
    host µs and the collectives' ms a step (``multihost.stats``)."""
    from crowdllama_tpu_torch.parallel import multihost

    r, tok, steps = engine.runner, engine.tokenizer, 8
    with torch.inference_mode():
        st = r.init_state()
        for slot in range(r.max_slots):
            ids = tok.encode(SHORT[slot % len(SHORT)] + str(slot))
            first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None, state=st)
            st = r.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                          prompt_tokens=ids)
        r.decode_steps(st, steps)  # warm
        torch.cuda.synchronize(dev)
        multihost.reset_stats()
        t0 = time.perf_counter()
        r.decode_steps(st, steps)
        torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        s = multihost.stats()
    return {"slots": r.max_slots, "step_ms": step_ms,
            "tokens_per_s": r.max_slots * 1e3 / step_ms,
            "frames": s["frames"],
            "frame_host_us_per_dispatch": s["frame_s"] * 1e6 / max(
                1, s["frames"]),
            "collective_ms_per_step": s["device_s"] * 1e3 / steps,
            "collectives_per_step": s["device_calls"] / steps,
            "collective_bytes_per_step": s["device_bytes"] / steps,
            "gather_ms_per_step": s["gather_s"] * 1e3 / steps,
            "host_copies": s["host_copies"]}


def _mp_leader(cfg, dev, model: dict, ran: set, checks: dict,
               tokens: int) -> dict:
    """Process 0's serve of one mesh: ``TorchEngine`` (its runner framed,
    ``parallel/replicated.py``) under the traffic, then the steady step
    and the prefill logits; STOP ends the follower's replay."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.parallel import multihost

    res: dict = {}

    async def go():
        engine = TorchEngine(cfg, **model)
        t0 = time.perf_counter()
        await engine.start()
        res["start_s"] = time.perf_counter() - t0
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        try:
            for k in ran:
                checks[_MP_CHECK_OF[k]].arm()
            _zero_launches()
            multihost.reset_stats()
            served = await serve(engine, _mesh_streams(), tokens,
                                 again="short0")
            res["launches"] = _launches()
            res["serve_stats"] = multihost.stats()
            res["serve_peak"] = torch.cuda.max_memory_allocated(dev)
            sched = engine.scheduler
            # The timing's INIT ends the follower's serve window.
            res["steady"] = await sched.on_dispatch_thread(
                _mp_step_timing, engine, dev)
            res["logits"] = (await sched.on_dispatch_thread(
                _mp_prefill_logits, engine.runner, engine.tokenizer,
                sched.state)).tolist()
            res["mesh"] = engine.describe()["mesh"]
        finally:
            await engine.stop()
        res["requests"] = served["requests"]
        res["wall_s"] = served["wall_s"]

    asyncio.run(go())
    return res


def _mp_follower(cfg, dev, model: dict, ran: set, checks: dict) -> dict:
    """Process 1's replay of one mesh's frames until STOP; its launches
    and peak memory in the serve window (between the second and the third
    INIT: build and warm-up before, the steady timing after)."""
    from crowdllama_tpu_torch.parallel import replicated

    windows, peaks = [], []
    real = replicated._apply

    def apply(runner, state, pending, job, op, *a):
        if op == replicated._OP_INIT:
            windows.append(_launches())
            peaks.append(torch.cuda.max_memory_allocated(dev))
            _zero_launches()
            for k in ran:
                checks[_MP_CHECK_OF[k]].arm()
        return real(runner, state, pending, job, op, *a)

    replicated._apply = apply
    try:
        frames = replicated.run_follower(cfg, **model)
    finally:
        replicated._apply = real
    windows.append(_launches())
    return {"frames": frames, "launches": windows[2],
            "serve_peak": peaks[2], "stopped": True}


def mp_child(pid: str, names: str, coord: str, out_dir: str) -> None:
    """One process of the multiprocess phase (``python -c "import
    chip_smoke; chip_smoke.mp_child(...)"``): join the group, then serve
    each mesh of ``names`` (a comma-separated list of MP_MESHES phases) in
    turn, on weights made on the card identically in both processes.
    Process 0 runs the engine (:func:`_mp_leader`), process 1 replays its
    frames (:func:`_mp_follower`).  Each writes, per mesh, its launches,
    its kernel-vs-plain errors, its peak memory and its collective
    counters to ``out_dir/<phase>_<pid>.json``."""
    import os

    from crowdllama_tpu_torch.parallel import multihost

    dev = _mp_device()
    meshes = {m[0]: m for m in MP_MESHES}
    multihost.initialize_from_config(_mp_config("1x2", "paged", coord,
                                                int(pid)))
    checks = _mp_seams()
    models: dict = {}
    for name in names.split(","):
        phase, spec, layout, ran, model, spec_decode, _ = meshes[name]
        cfg = _mp_config(spec, layout, coord, int(pid), model, spec_decode)
        kw = _mp_model(dev, model, models)
        for c in checks.values():
            c.reset()
        _free_card()
        torch.cuda.reset_peak_memory_stats(dev)
        multihost.reset_stats()
        if multihost.is_leader():
            res = _mp_leader(cfg, dev, kw, ran, checks, MESH_TOKENS)
        else:
            res = _mp_follower(cfg, dev, kw, ran, checks)
        res.update(pid=int(pid), phase=phase,
                   checks={k: checks[_MP_CHECK_OF[k]].err for k in ran},
                   checks_ok=all(checks[_MP_CHECK_OF[k]].ok for k in ran),
                   max_memory_allocated=res["serve_peak"],
                   stats=multihost.stats())
        with open(os.path.join(out_dir, f"{phase}_{pid}.json"), "w") as f:
            json.dump(res, f)
        _free_card()


def _mp_reference(dev, spec: str, layout: str) -> dict:
    """The one-process engine on the same mesh (both ranks on the one
    card) under the same traffic, TinyLlama cut to MESH_LAYERS: ids, TTFT,
    memory, prefill logits and the steady step."""
    kernel = None
    if layout == "contiguous":
        from crowdllama_tpu_torch.ops.cuda.flash import (
            flash_decode_attention as kernel,
        )
    c = _mp_config(spec, layout)
    engine, summary, reqs = run_engine(
        dev, _mesh_streams(), MESH_TOKENS, again="short0", mesh_shape=spec,
        devices=[dev, dev], kv_layout=layout, ragged_prefill=False,
        max_batch_slots=c.max_batch_slots, kv_page_size=c.kv_page_size,
        **_mesh_model(dev))
    logits = _mp_prefill_logits(engine.runner, engine.tokenizer,
                                engine.scheduler.state)
    steady = decode_step_timing(engine, dev, kernel)
    return {"ids": {k: v["ids"] for k, v in reqs.items()},
            "ttft_ms_median": summary["ttft_ms_median"],
            "max_memory_allocated": summary["max_memory_allocated"],
            "launches": summary["launches"], "logits": logits,
            "steady": steady, "source": "one-process engine, this phase"}


def _mesh_reference(phase: str, engine, summary: dict, reqs: dict,
                    steady: dict) -> dict:
    """A mesh phase's one-process line as a multiprocess reference: ids,
    TTFT, memory, launches, the steady step and the prefill logits of
    ``MP_LOGITS_PROMPT`` through its runner."""
    return {"ids": {k: v["ids"] for k, v in reqs.items()},
            "ttft_ms_median": summary["ttft_ms_median"],
            "max_memory_allocated": summary["max_memory_allocated"],
            "launches": summary["launches"],
            "logits": _mp_prefill_logits(engine.runner, engine.tokenizer,
                                         engine.scheduler.state),
            "steady": steady, "source": phase}


async def _mp_run(names: list[str], tmp: str) -> dict:
    """Both processes, serving the meshes ``names`` in one launch; each
    must exit 0 within ``MP_TIMEOUT_S`` (a child still alive then is
    killed and the phase fails).  Returns their reports by phase."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    coord = f"127.0.0.1:{_free_port()}"
    procs, errs = [], []
    for pid in ("0", "1"):
        err = open(os.path.join(tmp, f"mp_{pid}.err"), "w")
        procs.append(await asyncio.create_subprocess_exec(
            sys.executable, "-c", MP_CHILD, pid, ",".join(names), coord, tmp,
            cwd=root, stderr=err))
        errs.append(err)
    try:
        rcs = await asyncio.wait_for(
            asyncio.gather(*(p.wait() for p in procs)), MP_TIMEOUT_S)
    except asyncio.TimeoutError:
        rcs = None
    finally:
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        for e in errs:
            e.close()
    outs = {n: [os.path.join(tmp, f"{n}_{pid}.json") for pid in ("0", "1")]
            for n in names}
    if rcs is None or any(rcs) or not all(
            os.path.exists(o) for pair in outs.values() for o in pair):
        tails = []
        for pid in ("0", "1"):
            with open(os.path.join(tmp, f"mp_{pid}.err")) as f:
                tails.append(f.read()[-3000:])
        raise AssertionError(f"multiprocess: processes exited {rcs} (None: "
                             f"killed at {MP_TIMEOUT_S} s): {tails}")
    reports = {}
    for n, pair in outs.items():
        reports[n] = []
        for o in pair:
            with open(o) as f:
                reports[n].append(json.load(f))
    return reports


def multiprocess_phase(dev) -> dict:
    """Two processes on the one card serve every mesh of MP_MESHES in one
    launch (seed-0 bf16 weights, EOS column zeroed; 8 slots, context
    2,048, page 128): TinyLlama cut to MESH_LAYERS on "1x2" paged (tp
    across the processes, one rank each: A and B in each), "2x1"
    contiguous (dp across them: A and D), "1x2x1x1x1" (a pp stage each: A
    and D), "1x2x1x1" (an sp shard each: no kernel) and "2x1" with n-gram
    speculation (a dp rank each: A); mixtral-8x7b bf16 at MESH_EP_LAYERS
    on "1x2x1" paged (an expert bank each: A, B and G).  Traffic: 2
    greedy streams and the 1,465-token prompt, MESH_TOKENS tokens each,
    then one stream again.  The leader's line holds the streams, the
    prefill logits against the one-process engine on the same mesh (2% of
    their scale; tp's reference runs here, the others' is the mesh phase
    that served the same mesh in one process), the greedy share, each
    process's launches and kernel-vs-plain errors, the steady step beside
    the one-process mesh's with the frames' host µs and the collectives'
    ms split out, TTFT, memory per process and the collective backend;
    the follower's line its frames and its exit on STOP.  Returns the
    launches both processes add to the Dh-64 rows (A, B, D) and to G's and
    the Dh-128 rows (Mixtral: A, B, G)."""
    import tempfile

    refs = {}
    for phase, spec, layout, _, _, _, ref in MP_MESHES:
        if ref is None:
            refs[phase] = _mp_reference(dev, spec, layout)
            _free_card()
        else:
            refs[phase] = _MESH_REFS[ref]
    total = {"A": 0, "B": 0, "D": 0}
    total128 = {"A": 0, "B": 0, "G": 0}
    with tempfile.TemporaryDirectory(prefix="mp") as tmp:
        reports = asyncio.run(_mp_run([m[0] for m in MP_MESHES], tmp))
    for phase, spec, layout, ran, model, spec_decode, _ in MP_MESHES:
        ref = refs[phase]
        lead, follow = reports[phase]
        reqs = lead["requests"]
        for name, v in reqs.items():
            if not (v["done"] and v["completion_tokens"] == MESH_TOKENS):
                raise AssertionError(f"{phase}: stream {name} ended {v}")
        ids = {k: v["ids"] for k, v in reqs.items()}
        if ids["short0"] != ids["short0_again"]:
            raise AssertionError(f"{phase}: the repeated stream differs")
        add = total128 if model == MIXTRAL else total
        for rep in (lead, follow):
            _expect_launches(rep["launches"], ran,
                             f"{phase} process {rep['pid']}")
            for k in add:
                add[k] += rep["launches"][k]
            if (any(e is None for e in rep["checks"].values())
                    or not rep["checks_ok"]):
                raise AssertionError(f"{phase}: a kernel-vs-plain check "
                                     f"did not run or missed (atol "
                                     f"{ATOL}, rtol {RTOL}; G within "
                                     f"{GEMM_RTOL} of scale): "
                                     f"{rep['checks']}")
        logits = torch.tensor(lead["logits"])
        err = _logit_err(logits, ref["logits"])
        if not err["max_abs_err"] <= LOGIT_RTOL_TP * err["scale"]:
            raise AssertionError(f"{phase}: prefill logits against one "
                                 f"process {err}")
        if not follow.get("stopped"):
            raise AssertionError(f"{phase}: the follower did not stop")
        one_peak = ref["max_memory_allocated"]
        ttft = sorted(v["ttft_ms"] for k, v in reqs.items()
                      if not k.endswith("_again"))
        cut = ({"num_layers": [32, MESH_EP_LAYERS],
                "max_context_length": [32768, MOE_CONTEXT]}
               if model == MIXTRAL else {"num_layers": [22, MESH_LAYERS]})
        if phase in ("multiprocess_tp", "multiprocess_dp"):
            cut["max_tokens"] = [32, MESH_TOKENS]  # their earlier tokens
        emit({"phase": phase, "model": model,
              "layers": MESH_EP_LAYERS if model == MIXTRAL else MESH_LAYERS,
              "reduced": cut,
              "mesh": spec, "kv_layout": layout, "spec_decode": spec_decode,
              "processes": 2,
              "collectives": lead["mesh"], "start_s": lead["start_s"],
              "wall_s": lead["wall_s"],
              "requests": {k: {x: y for x, y in v.items()
                               if x not in ("ids", "text")}
                           for k, v in reqs.items()},
              "repeat_equal": True,
              "one_process_reference": ref["source"],
              "prefill_logits_vs_one_process": err,
              "logits_rtol": LOGIT_RTOL_TP,
              "greedy_tokens_equal_to_one_process": _greedy_share(
                  ref["ids"], reqs),
              "launches": {"leader": lead["launches"],
                           "follower": follow["launches"]},
              "one_process_launches": ref["launches"],
              "kernel_vs_plain_max_abs_err": {
                  "leader": lead["checks"],
                  "follower": follow["checks"]},
              "steady_decode": lead["steady"],
              "one_process_steady_decode": ref["steady"],
              "serve_collectives": lead["serve_stats"],
              "ttft_ms_median": ttft[len(ttft) // 2],
              "ttft_ms_max": ttft[-1],
              "one_process_ttft_ms_median": ref["ttft_ms_median"],
              "max_memory_allocated": {
                  "leader": lead["max_memory_allocated"],
                  "follower": follow["max_memory_allocated"]},
              "one_process_max_memory_allocated": one_peak,
              "memory_ratio_to_one_process": {
                  "leader": lead["max_memory_allocated"] / one_peak,
                  "follower": follow["max_memory_allocated"] / one_peak},
              "card": nvidia_smi()})
        emit({"phase": phase + "_follower", "mesh": spec,
              "frames_replayed": follow["frames"],
              "exit": "STOP, rc 0", "stats": follow["stats"],
              "card": nvidia_smi()})
    return {"dh64": total, "mixtral": total128}


KERNEL_ROWS = {
    "A": ("flash_prefill", "crowdllama_tpu_torch/csrc/flash_prefill.cu",
          "crowdllama_tpu/ops/pallas/flash.py:146"),
    "B": ("paged_decode", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:196"),
    "B_int8": ("paged_decode_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:159"),
    "C": ("ragged_paged", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:703"),
    "C_int8": ("ragged_paged_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:667"),
    "D": ("flash_decode", "crowdllama_tpu_torch/csrc/flash_decode.cu",
          "crowdllama_tpu/ops/pallas/flash.py:269"),
    "A_fp32": ("flash_prefill_f32",
               "crowdllama_tpu_torch/csrc/flash_prefill.cu",
               "crowdllama_tpu/ops/pallas/flash.py:146"),
    "D_fp32": ("flash_decode_f32", "crowdllama_tpu_torch/csrc/flash_decode.cu",
               "crowdllama_tpu/ops/pallas/flash.py:269"),
    "E": ("ragged_chunk", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:412"),
    "E_int8": ("ragged_chunk_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:376"),
    "F": ("paged_decode_tp", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:860"),
    "F_int8": ("paged_decode_tp_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:898"),
}
# Kernel G replaces no Pallas kernel: the rows name what it stands in for.
G_REPLACES = ("no Pallas counterpart: lax.ragged_dot "
              "(crowdllama_tpu/models/transformer.py:198) and qeinsum's "
              "dequant (crowdllama_tpu/ops/quant.py:138)")
G_ROWS = {"G": "grouped_gemm_bf16", "G_int8": "grouped_gemm_i8",
          "G_int4": "grouped_gemm_i4"}


def kernel_rows(res: dict, counts_by_dh) -> list[dict]:
    """The ``kernels`` line's attention rows: one a kernel and head dim
    (``counts_by_dh``: (head dim, launches by kernel) pairs), from the
    kernel lines' results ``res``."""
    from crowdllama_tpu_torch.ops.cuda import FP32_HEAD_DIMS

    rows = []
    for dh, counts in counts_by_dh:
        sfx = DH_SUFFIX[dh]
        for key, (kname, src, repl) in KERNEL_ROWS.items():
            if key in FP32_ROWS and dh not in FP32_HEAD_DIMS:
                continue
            r = res[key + sfx]
            rows.append({"name": kname + sfx, "head_dim": dh, "route": "cuda",
                         "source": src, "replaces": repl,
                         "launches": counts[key],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"],
                         **({k: r[k] for k in ("library_backend",
                                               "bound_fp32_fma_ms") if k in r})})
    return rows


def build_smem(kernels, dev) -> list[dict]:
    """Each attention entry's dynamic shared memory and blocks a SM at Dh
    64 (group 8), 128 (4), 256 (Gemma-2-9b's 2), 80 (H2O-Danube-1.8B's 4)
    and 96 (4), the fp32 entries at their own dims; not kernel G's, which
    have no head dim."""
    return [dict(kernels.kernel_resources(lib, sym, dh, g, dev), entry=sym,
                 dh=dh, group=g)
            for lib, entries in kernels.SIGNATURES.items()
            if lib != "grouped_gemm"
            for sym in entries
            for dh, g in ((64, 8), (128, 4), (256, 2), (80, 4), (96, 4))
            if not sym.endswith("_f32") or dh in kernels.FP32_HEAD_DIMS]


# The cut paths of a full-depth model's phase: the phase name's pattern,
# the kernels that launch on it, the engine's options.
def cut_paths_for(dev) -> tuple:
    return (("engine_{}_int8", {"A", "B_int8", "C_int8"},
             dict(kv_dtype="int8")),
            ("contiguous_{}", {"A", "D"}, dict(kv_layout="contiguous")),
            ("engine_{}_tp", {"A", "C", "F"},
             dict(mesh_shape="2", devices=[dev, dev])),
            ("engine_{}_tp_int8", {"A", "C_int8", "F_int8"},
             dict(mesh_shape="2", devices=[dev, dev], kv_dtype="int8")))


def danube_cut_phases(dev, launches: dict, cut_paths) -> dict:
    """H2O-Danube-1.8B's cuts to LLAMA_CUT_LAYERS layers on the other
    paths after its full-depth phase (``launches``, its counts): the rows'
    Dh-80 counts, every kernel of KERNEL_ROWS keyed."""
    for phase, ran, kw in cut_paths:
        _free_card()
        got = llama_cut_phase(dev, phase.format("danube_1_8b"), ran,
                              model=DANUBE, **kw)
        for k in ran - {"A", "C"}:
            launches[k] += got[k]
    return {k: launches.get(k, 0) for k in KERNEL_ROWS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from crowdllama_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "capability": list(cap),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability 9.0, got {cap}")

    t0 = time.perf_counter()
    kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [dict(r, library=lib) for lib in kernels.SIGNATURES
                    for r in kernels.ptxas_usage(lib)],
          "smem": build_smem(kernels, dev)})

    native_phase()
    from crowdllama_tpu_torch.engine import prng_golden

    emit({"phase": "threefry", **prng_golden.check(dev)})
    res = kernel_phase(dev)
    gemm = gemm_phase(dev)
    _free_card()
    paged = engine_phase(dev)
    launches = {k: paged["launches"][k] for k in ("A", "B", "C")}
    _free_card()
    # Megastep captures its graphs before any profiler session of the
    # process (the wire phase's is the first); its lines print after the
    # wire phase's, beside whose eager busy share they stand.
    mega_line, mega_profile = megastep_phase(dev, paged)
    _free_card()
    wire = wire_phase(dev)
    emit(mega_profile)
    emit({**mega_line, "wire_busy_share": wire["profile"]["busy_share"]})
    _free_card()
    cli_phase()
    for line in gateway_phase(dev):
        emit(line)
    _free_card()
    for line in kv_ship_phase(dev):
        emit(line)
    _free_card()
    relay_phase(dev)
    from crowdllama_tpu_torch import native

    # Every phase so far ran the native data plane with no fallback; the
    # split phase's Python half is the first to count one.
    _native_ok("chip_smoke", {"native": native.stats()})
    _free_card()
    aead_split_phase(dev)
    _free_card()
    launches["F"] = tp_phase(dev, paged)["F"]
    _free_card()
    launches["F_int8"] = tp_int8_phase(dev)["F_int8"]
    _free_card()
    int8 = int8_paged_phase(dev, paged)
    launches.update({k: int8[k] for k in ("B_int8", "C_int8")})
    _free_card()
    launches["D"] = contiguous_phase(dev)
    _free_card()
    int8_contiguous_phase(dev)
    _free_card()
    # The in-mesh axes, every rank on the one card: A and D at Dh 64 join
    # the rows' counts, and mesh_ep's A, B, C (Dh 128) and G below.
    mesh64, mesh_ep = mesh_phases(dev)
    for k, n in mesh64.items():
        launches[k] += n
    _free_card()
    # One worker over two processes on the one card: each process's A, B
    # and D launches join the Dh-64 rows (TinyLlama), its A, B and G
    # launches the Dh-128 and G rows (Mixtral, added below).
    mp = multiprocess_phase(dev)
    for k, n in mp["dh64"].items():
        launches[k] += n
    _free_card()
    spec_phase(dev)
    _free_card()
    autotune_phase(dev)
    _free_card()
    gemm_launches = moe_phase(dev)
    _free_card()
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hfkeep") as keep:
        emit(hf_phase(dev, keep))
        _free_card()
        emit(share_phase(dev, os.path.join(keep, SHARE_NAME)))
    _free_card()
    line, fp32 = distill_phase(dev)
    emit(line)
    launches.update(fp32)
    _free_card()
    # Dh 128: llama-3-8b at full depth on the paged main path, then cut to
    # LLAMA_CUT_LAYERS layers on the other paths.
    llama = llama_phase(dev)
    paged128 = llama["launches"]
    launches128 = {k: paged128[k] for k in ("A", "B", "C")}
    cut_paths = cut_paths_for(dev)
    for phase, ran, kw in cut_paths:
        _free_card()
        got = llama_cut_phase(dev, phase.format("llama"), ran, **kw)
        launches128.update({k: got[k] for k in ran - {"A", "C"}
                            if k not in launches128})
    _free_card()
    # Dh 256: Gemma-2-9b at full width and depth on the paged main path,
    # then cut to LLAMA_CUT_LAYERS layers on the other paths.
    launches256 = gemma2_phase(dev)
    for phase, ran, kw in cut_paths:
        _free_card()
        got = llama_cut_phase(dev, phase.format("gemma2_9b"), ran,
                              model=GEMMA9, **kw)
        for k in ran - {"A", "C"}:
            launches256[k] += got[k]
    _free_card()
    # The fp32 entries at Dh 256: distill-draft with a Gemma-2-9b teacher.
    line, fp32 = distill_gemma2_phase(dev)
    emit(line)
    launches256.update(fp32)
    _free_card()
    # Dh 80: H2O-Danube-1.8B at full width and depth on the paged main
    # path, then cut to LLAMA_CUT_LAYERS layers on the other paths.
    launches80 = danube_cut_phases(dev, danube_phase(dev), cut_paths)
    _free_card()
    quant_phase(dev, llama["steady"])
    _free_card()
    for k in ("A", "B", "C"):
        launches128[k] += mesh_ep[k]
    gemm_launches["G"] += mesh_ep["G"]
    for k in ("A", "B"):
        launches128[k] += mp["mixtral"][k]
    gemm_launches["G"] += mp["mixtral"]["G"]
    # Sharded serving across workers: the launches of A and D (Dh 128)
    # and of G (bf16) on those paths join the rows' counts.
    for strategy in ("pp", "ep"):
        line = shard_phase(dev, strategy)
        for k in ("A", "D"):
            launches128[k] += line["launches"][k]
        gemm_launches["G"] += line["launches"].get("G", 0)
    # No engine path runs kernel E; every phase checked it stayed at 0.
    # The fp32 entries run at Dh 64 and 256, in the distill phases.
    launches["E"] = launches["E_int8"] = 0
    launches128["E"] = launches128["E_int8"] = 0
    launches128["A_fp32"] = launches128["D_fp32"] = 0
    launches256 = {k: launches256.get(k, 0) for k in KERNEL_ROWS}
    # No served model has head dim 96: its rows' kernels ran only in the
    # kernel phase.
    launches96 = {k: 0 for k in KERNEL_ROWS}

    rows = kernel_rows(res, ((64, launches), (128, launches128),
                             (256, launches256), (80, launches80),
                             (96, launches96)))
    for key, symbol in G_ROWS.items():
        fmt = {"G": "bf16", "G_int8": "int8", "G_int4": "int4"}[key]
        r = gemm[fmt]
        rows.append({"name": symbol, "head_dim": None, "route": "cuda",
                     "source": "crowdllama_tpu_torch/csrc/grouped_gemm.cu",
                     "replaces": G_REPLACES, "launches": gemm_launches[key],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "library": r["library"], "shape": GEMM_ROW_CASE,
                     "schedule": r["schedule"], "split": r["split"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_main(name: str) -> int:
    """One phase alone after the build (``--phase multiprocess``;
    ``--phase gemma2`` or ``distill_gemma2``: the Dh-256 kernel line and
    ``engine_gemma2_9b`` or ``distill_gemma2_9b``, then the kernels line
    of their rows; ``--phase danube``: the Dh-80 and Dh-96 kernel lines,
    ``engine_danube_1_8b`` and its cuts, then the kernels line of their
    rows): its lines, then the contract's last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if name not in ("multiprocess", "gemma2", "distill_gemma2", "danube"):
        print(f"chip_smoke: no phase {name!r} runs alone", file=sys.stderr)
        return 2
    from crowdllama_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          **({"ptxas": [dict(r, library=lib) for lib in kernels.SIGNATURES
                        for r in kernels.ptxas_usage(lib)],
              "smem": build_smem(kernels, dev)} if name != "multiprocess"
             else {})})
    if name == "danube":
        gen = torch.Generator(device=dev).manual_seed(0)
        res = {}
        for line in KERNEL_LINES[-2:]:
            res.update(kernel_line(dev, gen, *line))
        _free_card()
        counts = danube_cut_phases(dev, danube_phase(dev), cut_paths_for(dev))
        print(json.dumps({"kernels": kernel_rows(res, (
            (80, counts), (96, {k: 0 for k in KERNEL_ROWS})))}), flush=True)
    elif name != "multiprocess":
        res = kernel_line(dev, torch.Generator(device=dev).manual_seed(0),
                          *KERNEL_LINES[2])
        _free_card()
        if name == "gemma2":
            counts = gemma2_phase(dev)
        else:
            line, counts = distill_gemma2_phase(dev)
            emit(line)
        print(json.dumps({"kernels": kernel_rows(res, ((256, {
            k: counts.get(k, 0) for k in KERNEL_ROWS}),))}), flush=True)
    else:
        # The cut meshes stand beside the mesh phases' one-process lines.
        mesh_phases(dev)
        _free_card()
        emit({"phase": "multiprocess_launches", **multiprocess_phase(dev)})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"] and len(sys.argv) == 3:
        sys.exit(phase_main(sys.argv[2]))
    sys.exit(main())
