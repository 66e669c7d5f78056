#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gofr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit != 0):

1. env     — the card (``nvidia-smi`` name and power limit), torch/CUDA.
2. build   — builds the CUDA kernels from ``gofr_tpu_torch/csrc/``
             (five sources, one ``nvcc`` each, in parallel) into
             ``build/``: flash prefill, paged decode, the paged chunk
             source, which holds both the chunk and the tree-verify
             kernel, the KV row write and the weight-dequantizing GEMM.
3. kernels — each of the four kernels (flash prefill, paged decode,
             paged chunk, paged tree verify) against its plain PyTorch
             version on the card, at the serving path's shapes, bf16,
             ragged lengths; then the int8 branch of each paged kernel on
             ``quantize_pool`` of the same pools, against the plain
             version over the dequantized view: seven rows; then flash
             at wave 1's widest bucket (one 1024-row prompt, kv_lengths
             901) and the chunk kernel at GQA group 3 (Hq 12, Hkv 4): nine
             rows. CUDA event
             times (median of 25 after warm-up, ``ms``: the call, its
             Python wrapper included) of the kernel, the plain version
             and one PyTorch library call of the same function (for
             int8, SDPA on the view dequantized beforehand, untimed);
             ``torch.profiler`` device times of the kernel and of all of
             the library call's kernels (``device_ms``,
             ``library_device_ms``); the roofline bound of the work, and
             the split count S the wrapper chose. A planted fault (a
             shortened length, V rows read one position late, a dropped
             or swapped page, causal masks in place of tree masks, and
             for int8 the V scales shifted one row within each page) must
             fail the same check. The tree
             kernel must also leave every node outside a poisoned sibling
             branch bit for bit unchanged, and give the chunk kernel's
             output bit for bit on a chain and under causal masks, in
             both forms. Then the same checks and times for one request
             (B=1, S=8): decode over 2047 rows, a tree verify over 1900
             history rows, both forms (their own kernel lines). Then the
             KV write kernel's three entries, both forms: the per-layer
             write (``kv_write``, off the main path since the fused
             entry took the steps' write) at a decode step's 8 rows on
             the serve pool, 3 of them out of range: its pools must
             equal the plain version's bit for bit, and a planted fault
             (bf16 rows one offset late, int8 V scales shifted one row)
             must not; the slab write at the group prefill's slab
             through ``scatter_chunk_kv``, one launch for every layer (P
             = 8 in the 512-row bucket: 6 x 301 rows, 2 dummy rows on
             all-OOB tables), bit for bit against
             ``scatter_chunk_kv_plain`` with rows written one offset
             late as the planted fault; and the fused RoPE + K/V write
             (``rope_kv_write``) at the decode step's 8 rows (positions
             0-2047) and at a verify's 8 x 16 tree nodes (RoPE at the
             depth, rows at the node index, Llama-3.2 ``rope_scaling``),
             rotated q and pools bit for bit against
             ``rope_kv_write_plain``, with positions one late, the
             rotate-half sign flipped and, for int8, the amax taken
             before the bf16 rounding as planted faults; beside each,
             ``index_copy_`` of the in-range rows as the nearest library
             path, and for the fused rows the unfused ``apply_rope`` x 2
             + ``kv_write``: seventeen rows. Then the
             weight-dequantizing GEMM (``wq_gemm``, int8
             and int4 codes) at llama3_1b's products — wq, wk, w1, w2
             and the tied head, every matrix in the one ``[N, K]``
             layout — at M = 1, 8 and 128 against its plain version
             (the float32 head within float32 summation error; two
             calls bit-equal; scales shifted one channel, codes
             k-permuted, the square wq's codes transposed, swapped int4
             nibbles and the head rounded to bf16 as planted faults),
             beside cuBLAS bf16 on the weights dequantized beforehand;
             the M = 8 rows join the kernels line. The
             ``wq_gemm_route`` line: the kernel against the plain route
             at w1's shape over M = 16..2048, and which route each
             product of the serving path takes.
4. moe_tie — the MoE router's tie order on the card: tied router logits
             pick the lowest expert indices, as ``lax.top_k`` does (all
             tied: [0, 1]; a tie for second: [5, 2]), and ``moe_layer``
             under a zero gate mixes experts 0 and 1; a highest-index-
             first order as the planted fault.
   model   — Llama-3.2-1B shape (``llama3_1b``), random bf16 weights from
             seed 0: ``llama_prefill_last`` + 3 ``llama_decode_step_paged``
             steps through the kernels and through the plain versions
             (the prompt's and each step's K/V writes included) on the
             same inputs; logits must agree, and a planted fault in
             the decode kernel's lengths must not. Then
             ``llama_prefill_chunk_paged``: kernels vs plain on a chunk
             with and without history (a planted history fault must
             fail), and an 1800-token prompt walked in two chunks vs
             whole-prompt flash prefill.
   model_spec — a ~400-token prompt, 6 sequential greedy decode
             steps, then a 9-node draft tree (a decoy branch and the
             chain of the decoded tokens) verified in tree mode through
             the kernels and the plain versions: node logits agree, the
             chain's logits are the decode steps', the resolve accepts
             the chain as far as the decode margins allow, causal masks
             move the logits, and one decode step after the accepted
             path's rows are compacted gives the sequential logits.
   model_int8 — one int8 pool: flash prefill written quantized, 3 decode
             steps, a chunk after that history and one tree verify,
             through the int8 kernels and through the plain versions;
             logits must agree (the int8-vs-bf16 pool difference is
             printed, not gated).
   model_wq — llama3_1b with int8, then int4 weights: prefill, a
             decode step and a chunk through the kernels against the
             plain path (every quantized product dequantized), within
             LOGITS_TOL; the decode step's 113 products all through
             ``wq_gemm`` and none dequantized; scales shifted one channel
             as the planted fault; the decode graph's replay bit for bit
             against its uncaptured pass, 8 x 113 ``wq_gemm`` launches a
             replay.
   decode_graph — the compiled decode dispatch at ``llama3_1b`` on
             ``serve_config``, K = 8, M = 1 and 2, bf16 and int8 pools, a
             greedy and a mixed batch: the graph's replay against the
             uncaptured pass on the same state and cloned pools, bit for
             bit; a replay fed stale tables (a planted fault) must not
             agree; every replay writes through ``rope_kv_write`` once a
             layer and step and never through ``kv_write``; replay and
             uncaptured ms per dispatch, launches per replay.
5. serve   — the port's HTTP app (``gofr_tpu_torch.serving.app``) on a
             free port: 4 concurrent greedy ``POST /chat`` requests, an
             1801-token prompt (walked in chunks, not clamped), then 3
             requests that hit the prefix cache; every kernel's launch
             counter, zeroed just before, must rise (the fused RoPE +
             K/V write's and the prefill slab write's too), and the
             per-layer ``kv_write`` must stay at 0. Every serve run
             prints the dispatch
             counters: graph captures and replays, capture seconds,
             scheduler syncs and host-to-device transfers, and decode
             tokens/s without the captures.
   serve_int8 — the same three waves through ``serve_config(kv_dtype=
             "int8")`` at the bf16 pool's byte budget: at least 1.8x its
             pages in no more bytes, every answer 201, the int8 decode
             and chunk counters (zeroed just before) must rise and the
             bf16 ones stay 0; TTFT, decode tokens/s and each answer's
             common prefix with the bf16 answers are printed.
   serve_obs — the accounting and integrity planes through the app
             (``phase_serve_obs``' docstring): (a) serve's waves with the
             planes off and on, each wave admitted as one batch: equal
             digests, scheduler syncs, uploads, captures and launches;
             (b) goodput conserved, padding as the pass records imply, a
             bubble; (c) golden probes sealed from the planes-off engine,
             none mismatching, and one episode under ``logit_corrupt``;
             (d) one cost-drift episode under ``cost_skew``, none
             without, ``/debug/costs`` listing every signature run; (e)
             ``pass_stall``: DEGRADED then UP, one watchdog episode;
             (f) ``/metrics`` holding every JAX engine series, the e2e
             count, the MFU gauge = tokens/s x flops per token / peak.
             Every check rejects a planted fault.
   serve_recover — the recovery and forensics planes through the app
             (``phase_serve_recover``' docstring): (a) a group prefill
             that raises once fails only its group; (b) ``pass_raise``
             with walkers before their first token and a decode dispatch
             in flight: they recover with the clean run's digests, no
             capture, allocation or launch per replay moves; mid-stream
             requests answer a typed 503 ``engine_restart``; (c) the
             budget spent: DOWN, a ``restart_budget`` incident bundle,
             ``engine_down``; (d) one trace from the HTTP span to
             ``engine.retire``, ``X-Trace-Id``, the exemplar; (e) a
             captured workload replayed with 0 divergences, and located
             ones under ``logit_corrupt``; (f) ``torch.profiler`` captures
             naming the kernels of replayed graphs, refused, auto-stopped
             and forced, tokens/s with the profiler armed and off. Every
             check rejects a planted fault.
   serve_fleet — the fleet plane (``phase_serve_fleet``' docstring):
             three ``llama3_1b`` workers joined to one leader with the
             prefix-aware router, two families of requests led by
             512-token system prompts; (a) the device registry, (f) the
             integrity vote quarantining the worker whose canaries are
             corrupted, (b) prefix digests reaching the leader, (c)
             every wave-2 request on its family's owner with a prefix
             hit (planted: a round-robin leader), (d) routed = direct
             answers, SSE = unary, the router's added TTFT, (e) a drained
             owner's typed 503s retried on the survivor while its stream
             ends whole, (h) the federated metrics, (g) eviction after 3
             missed heartbeats; every check rejects a planted fault.
6. serve_spec — 4 concurrent greedy ``/chat`` requests with repetitive
             prompts, 64 new tokens each, through the plain engine, the
             speculative one (``serve_config(speculative=True,
             spec_ngram=2)``) and the speculative one on an int8 pool;
             the tree kernel's counter for the run's pool form, zeroed
             just before each speculative run, must rise, and drafts
             must be made.
   serve_wq — the serve waves with int8, then int4 weights on the
             bf16 pool, after ``engine.warmup()``: ``wq_gemm``'s counter
             must rise; weight bytes; then one decode dispatch's device
             ms with bf16, int8 and int4 weights.
7. serve_preempt — the scheduling core: 8 greedy requests (6 x 301 +
             2 x 901 prompt tokens, 256 new each) queued before
             ``start()`` after ``engine.warmup``, on an ample and a dry
             pool (``kv_pages=64``) at pipeline depth 0 and 1, and on an
             ample and a dry-sized int8 pool: completion, preemption on
             the dry bf16 pool, tokens bit-equal to the ample depth-0
             run of the pool form up to each request's first
             preemption, balanced page books, no capture while serving,
             the counters rising; three planted faults must each fail a
             check. Also one 8 x 301 group prefill's host-blocked ms with
             the sync-free and the plain K/V write.
8. checkpoint — the seed-0 llama3_1b weights written as a sharded HF
             checkpoint with a ``tokenizer.json`` in a temporary
             directory, the app booted from it (``MODEL_PATH``,
             ``MODEL_QUANT=int8``), one greedy ``POST /chat``: its tokens
             bit for bit the in-memory int8 engine's, its prompt counted
             by the BPE tokenizer.
9. serve_moe — the Mixtral-style MoE family (``moe_engine``) at
             Mixtral-8x7B width, 2 of its 32 layers (4 until the
             attention kernels took every head dim and type, 8 until
             train_mesh joined the script), random bf16 weights,
             through the app on the slot layout, the paged layout's dense
             view (bf16, and int8 with decode windows 512 / 1024) and the
             slot layout with those windows: four waves (serve's wave 1,
             the 1801-token prompt clamped to the widest bucket, a
             101-token and a 1001-token prompt), checks (a)-(f) with their
             planted faults (``phase_serve_moe``' docstring): slot = view
             bit for bit, windows = the full graph, the int8 pool through
             the slab kernel, flash vs plain logits at D = 128, graphs and
             uploads, a restart keeping graphs and memory. Also the
             decode step's MoE-MLP share, the view's gather and
             write-back ms and the peak memory. Its flash and slab
             launches are the D = 128 kernel rows' (``flash_attention_
             d128``, ``kv_write_view_d128`` / ``_int8``: the flash kernel
             at Mixtral's heads, P 4, S 512, and the slab write of a
             decode dispatch's view write-back, both forms, each with its
             planted fault, among the kernel rows above).
10. serve_llama8b — Llama-3-8B (``llama3_8b``: hd 128) at full width,
             4 of its 32 layers (the full 32, 16.06 GB, until serve_tp
             joined the script, 16 until train_mesh did, 8 until the
             attention kernels took every head dim and type;
             ``phase_serve_llama8b`` takes any depth), random weights,
             through the app on the native paged layout (bf16; int8 with
             speculation), the slot layout, the view (``paged_attention=
             "view"``, windows 512 / 1024), and speculative on the native
             and the slot layout: serve's three waves and serve_spec's
             prompts; checks (a)-(i) with their planted faults
             (``phase_serve_llama8b``' docstring): slot and view agree,
             speculative and plain agree, the 1801-token prompt walks
             whole on the dense layouts, prefix hits on the view, kernel vs
             plain logits on a decode step and a chunk, no capture while
             serving, the weight bytes, every kernel launched. Also a
             decode step's device ms natively and on the slot layout, by
             kernel kind. Its launches are the D = 128 kernel rows'
             (``paged_decode_attention_d128``, ``paged_chunk_attention_
             d128``, ``paged_tree_attention_d128``, ``rope_kv_write_d128``,
             each with ``_int8``, among the kernel rows above: the
             kernels at Llama-3-8B's heads, the checks of the D = 64 rows
             with their planted faults).
11. serve_embed — BERT-base (``BertConfig.base()``, bf16, random
             weights from seed 0) behind ``POST /embed`` of ``embed_app``:
             (a) 32 texts of 20-500 bytes give 32 finite unit-norm
             embeddings of dim 768, (b) each text alone equals its row of
             the padded batch, (c) bf16 agrees with a float32 copy of the
             weights on the card, and that copy's hidden states with the
             host's; planted faults: no L2 normalisation, no attention
             mask, the exact-erf gelu (``phase_serve_embed``' docstring).
             p50 latency, sentences/s at batch 8 and 32, the encode's
             device ms and bound, weight bytes, peak memory. No kernel of
             the repository lies on this path (JAX's BERT calls XLA
             attention).
12. serve_asr — Whisper-large-v3 (bf16, random weights from seed 0)
             through ``asr_app`` on synthetic 1 / 5 / 10 / 30 s PCM:
             (a) the card's log-mel against float64 numpy, (b) the bf16
             encoder against float32, (c) a batch of 8 transcripts read
             back through the teacher-forced decoder, (d) ``POST
             /transcribe`` = ``Transcriber.transcribe_batch``, (e) the
             pub/sub worker: 10 messages, one poison, 3 device batches,
             9 results, nothing uncommitted, (f) a ``whisper_tiny`` HF
             checkpoint served through ``MODEL_PATH`` bit for bit; each
             with its planted fault (``phase_serve_asr``' docstring).
             Encode device ms at batch 1 / 4 / 8, a decode step's ms and
             device ms, utterances/s, audio seconds per wall second,
             weight bytes, peak memory. No kernel of the repository lies
             on this path either.
13. serve_warm — checkpoint/resume at Llama-3-8B's full width (4 of its
             32 layers, 3.85 GB of bf16, random from seed 0) and the C++
             BPE merge loop (``phase_serve_warm``' docstring): (a)
             ``Checkpointer.save`` / ``restore`` bit for bit, bf16 stored
             as its bits; (b) ``restore_engine`` behind ``build_server``:
             a streamed and a unary greedy ``/chat`` bit for bit the
             in-memory engine's; (c) a 2,048-merge ``tokenizer.json``
             learned from seeded text, the native loop live and equal to
             the Python loop on 1 MB; (d) JAX's text on a port ``App``
             (``warm_start(app, ...)`` as an on-start hook, ``llama_engine(
             metrics=, logger=, tracer=)``, ``install_openai_routes(app=)``):
             ``/chat`` streamed and unary and ``/v1/chat/completions`` bit
             for bit the in-memory engine's, flash and paged decode
             launches > 0; each with its planted fault (an empty
             directory's start must fail naming the model). Bytes, save /
             restore s and GB/s, seconds from ``restore_engine`` and from
             the ``App``'s start to the first token, peak memory, native
             and Python encode MB/s. The engine behind it runs the kernels
             as serve does; no kernel's row takes its launches from it.
14. serve_app — the framework surface: ``serving/model_serving.
             build_app`` (``App.serve_model`` + the OpenAI routes) with
             ``MODEL_PRESET=llama3_1b``, API-key auth and the profiler
             routes on, on an event loop in a thread, beside
             ``build_server`` on the same engine (``phase_serve_app``'
             docstring): (a) alive and health naming the engine and the
             card; (b) a 9-request unary ``/chat`` wave (one prompt walked
             through the chunk kernel), App / ChatServer / ChatServer /
             App, tokens and digests equal; (c) the same through ``/chat``
             and ``/v1/chat/completions`` streams, and a client that
             leaves frees its slot; (d) a trace through the app's
             ``/debug/profile`` routes names the flash, paged decode,
             paged chunk and ``rope_kv_write`` kernels; (e) 401 without a
             key, the tenant label with one; (f) the HTTP histogram by
             route pattern, the engine gauges, ``app_gpu_device_count``;
             (g) the SIGTERM drain with 4 requests in flight; each with
             its planted fault. TTFT, SSE gaps and decode tokens/s
             through both servers; the launch counters of the phase.
15. serve_ws — the framework's batteries on the card: the same app with
             ``DB_DIALECT=sqlite`` and the embedded ``REDIS_HOST``, two
             migrations, auto-CRUD over a ``conversation`` table and a
             chat handler over ``/ws/chat`` (user code in this script,
             ``phase_serve_ws``' docstring): (a) migrations applied once,
             a failing version rolled back, health UP with sql, redis and
             the engine; (b) 16 sockets on the 8 slots, gated, tokens and
             digests equal to unary ``/chat``; (c) every socket's row read
             back through ``GET /conversation/{id}``, its text in redis;
             (d) a socket closed after 3 frames frees its slot; (e) a
             malformed frame answered with an error and the socket served
             on, ``GET /ws/chat`` 426; (f) the kernels' launches rise over
             the wave, and ``App.stop`` closes every socket; each with its
             planted fault. TTFT and frame gaps over the sockets beside
             ``/chat`` streams, decode tokens/s.

16. serve_wire — every backend the container reads from config: the
             same app booted through config keys alone against the port's
             Mini servers (``DB_DIALECT=postgres``, ``REDIS_MODE=network``,
             ``PUBSUB_BACKEND=KAFKA``, ``TRACE_EXPORTER=otlp``,
             ``REMOTE_LOG_URL``; ``phase_serve_wire``' docstring), a job
             handler on four Kafka topics (user code in this script): (a)
             the migration over the wire, health UP with sql, redis, pubsub
             and the engine; (b) 16 jobs beside 8 ``/chat`` streams,
             answers equal to unary ``/chat``; (c) rows and texts read back
             over the wire; (d) committed offsets; (e) the jobs' spans at
             the collector with their SQL and redis children, and the
             remote log level; (f) the kernels' launches rise, ``App.stop``
             closes every client; (g) mysql, oracle, EventHub, NATS,
             JetStream, MQTT and Google each carry a job; each with its
             planted fault. Job latency beside ``/chat``'s, decode
             tokens/s, the wire ops' times.
17. serve_stores — the breadth stores: the same app with the port's
             Mini servers of 16 stores on loopback in the container's
             slots (``phase_serve_stores``' docstring): (a) migrations
             over the Cassandra, ClickHouse and Mongo wires; (b) 16
             ``/answer`` requests on 8 slots, each answer kept in seven
             stores, equal to unary ``/chat``; (c) every answer read back
             over every wire; (d) the other nine wire clients; (e) the
             kernels' launches rise, ``App.stop`` closes every client;
             each with its planted fault. A store write's time under load
             and idle, ``app_<store>_stats`` p50s.
18. serve_cli — the CLI (``app.new_cmd``, ``cli/cmd.CMDApp``): the
             engine by ``add_model``, an ``FTPFileSystem`` and a ``NATSKV``
             on the port's Mini FTP and JetStream servers; user
             subcommands ``generate``, ``batch``, ``answers get`` / ``rm``
             (``phase_serve_cli``' docstring): (a) ``generate``'s tokens
             and ``request_digest`` equal a direct submit's; (b) ``batch
             --n=8`` (one prompt walked, one a prefix hit) equal to single
             runs; (c) every answer read back over FTP and NATS-KV,
             ``answers rm`` then ``get`` exits 1; (d) ``help`` / ``-h`` /
             an unknown subcommand's exit codes, also through a
             subprocess; (e) the kernels' launches rise over ``batch``;
             each with its planted fault. ``generate``'s wall and TTFT,
             ``batch``'s decode tokens/s, the stores' times idle and
             under ``batch``.
19. serve_examples — the apps of ``examples_torch/`` and the operator
             tools (``phase_serve_examples``' docstring): the
             ``model-serving`` example's own ``build_app`` at
             ``llama3_1b`` (4 slots, ``max_seq`` 8192): (a) 8 ``/chat``
             requests on the 4 slots (one walked, two prefix hits), 2
             ``/v1/completions`` and a streamed ``/v1/chat/completions``
             equal to single runs, health UP; (b) the same with
             ``MODEL_QUANT=int8``; (c) ``scripts/bundle.py`` against it;
             (d) the bundle's workload replayed on a fresh engine of the
             example; (e) ``scripts/torch_capacity.py``'s sweep over it
             and its setpoint read by the router; (f)
             ``scripts/torch_replay.py`` on a workload captured from the
             demo engine (exit 0, and 2 on a changed token); (g) the
             ``asr-worker`` example at ``whisper_large_v3``; (h) the
             kernels' launches rise under (a) and (b); each with its
             planted fault. TTFT, decode tokens/s, the replay's and the
             capacity curve's rates, the bundle's size, utterances/s.
20. train_llama — the trainer (``gofr_tpu_torch/parallel/``) at
             ``llama3_1b``'s full width and depth, bf16, random weights
             from seed 0, on a ``{dp: 1, tp: 1}`` mesh over a one-rank
             ``nccl`` group, one fixed 4 x 512 batch
             (``phase_train_llama``' docstring): (a) the first loss
             against the serving forward's (the flash kernel) and every
             token's; (b) bf16 gradients against a float32 copy's, per
             layer and matrix; (c) 8 steps: the loss falls, finite
             gradient norms; (d) save at step 2, restore, steps 3-4 bit
             for bit, deterministic; (e) ring attention at sp = 1 and a pp
             = 1 GPipe step with M = 2 against the plain and the dense
             paths; each with its planted fault. Step ms, tokens/s, MFU,
             peak memory, the optimizer's bytes, save / restore seconds.
             The trainer runs no kernel of the repository (plain
             attention, as JAX's trainer runs XLA's); the kernel line is
             unchanged by it.
21. serve_tp — serving on a tensor-parallel mesh at Llama-3-70B's width
             (``llama3_70b``: dim 8192, 64 q / 8 KV heads, hd 128, ffn
             28672, vocab 128256), 4 of its 80 layers (8 until
             train_mesh joined the script), bf16, random
             weights from seed 0 (11.0 GB; ``phase_serve_tp``'
             docstring): the unsharded engine as the reference; (c) tp = 1
             over a one-rank ``nccl`` group with the decode graph captured
             (tokens bit-equal); (b) tp = 2 as two rank processes sharing
             the card over ``gloo`` (tokens equal or parting at a near
             tie, each rank's weight and pool bytes half, flash and slab
             launches); each with its planted fault. TTFT and decode
             tokens/s of each, the host-staged all-reduce. Its launches
             are the kernel rows ``flash_attention_tp2`` and
             ``kv_write_prefill_tp2`` (flash at Hq 32 / Hkv 4 / D 128 and
             the slab write at Hkv 4, one rank's shapes, each with its
             planted fault, among the kernel rows above).

22. train_mesh — the trainer on a mesh on the card: four ``gloo`` rank
             processes sharing it (``phase_train_mesh``' docstring), each
             job against the port's one-rank step: (a) ``llama3_1b``
             uncut at ``{dp: 2, tp: 2}``, (b) GPipe at ``{dp: 2, pp:
             2}``, M = 4, (c) Mixtral-8x7B width, 1 layer, at ``{dp: 2,
             ep: 2}``, (d) ring attention at sp = 4 (q / k / v [1, 8192,
             32, 64], float32), (e) (a)'s state saved whole after step 2
             and restored slice by slice, steps 3-4 bit for bit; each
             with its planted fault. Step ms, tokens/s, the collectives'
             ms a step, each rank's peak memory. No kernel of the
             repository lies on this path.

Kernel rows at the other head dims, types and groups (``kernel_shapes``
for ``SHAPE_CASES`` and ``WIDE_GROUP_CASES``): each attention row names
its route (``kernel_route``, ``_build.attention_route``: the split-KV
decode kernel in every type, the ``wgmma`` kernels for 16-bit flash,
chunk and tree, the float32 FMA kernel for float32) and its source, and
is held to its plain version within ``_tols`` (a P-rounding term on the
``wgmma`` route: 2^-8 in bf16, 2^-11 in float16), with its planted
fault; GQA groups 32 and 48 run on sub-groups of 16 heads.

Phases 9-22 each print their wall time (``phase_wall_s``).

Then a ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line and, as
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero with no
result when CUDA is absent or the package is not beside this script.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain, per element: |out - ref| <= atol + RTOL |ref|
# (+ P_ROUND · sum_j p_j |v_j| / l for flash and paged chunk). Both
# sides round their output to bf16 (each <= 2^-8 relative), so RTOL =
# 2^-7. Flash and paged chunk also round each softmax weight p_j to
# bf16 (<= 2^-8 relative) before P·V
# while l sums the float32 weights: its output moves by at most 2^-8 of
# the attention average of |V|, which for a row that averages
# cancelling values is far above 2^-8 |out|. The atol covers the
# float32 exp and summation-order differences.
RTOL = 2.0 ** -7
P_ROUND = 2.0 ** -8
ATOL = 1e-3
# The float32-out rows (the LM head of wq_gemm): both sides sum the same
# bf16 products in float32 and scale by the same float32 scale, so they
# differ by summation order only (measured worst 5.3e-6 abs at |ref| <~ 5
# on the H100); a head rounded to bf16 anywhere (<= 2^-9 relative) fails.
RTOL_F32 = 2.0 ** -12
ATOL_F32 = 1e-4
LOGITS_TOL = 0.1    # see phase_model and phase_model_spec
#: traces ``device_ms`` takes before it gives up on one with device time
PROFILER_TRIES = 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median CUDA-event time of one call of ``fn``: the call's time,
    its Python wrapper and launch included (the card is idle when each
    call starts)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, warmup: int = 3, iters: int = 25,
              cold: bool = False, only: str | None = None) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels (and copies) it ran on the card, from ``torch.profiler`` over
    ``iters`` calls after warm-up — the median per call when every call
    ran the same number of them, else the mean. Host time is left out.
    A trace that holds no device event of the call (the profiler drops
    one now and then, three in a row in one run) is taken again after a
    pause, up to PROFILER_TRIES times. ``cold``: a 64 MiB
    buffer is zeroed before each call, so the call finds the 50 MB L2
    cache holding none of its inputs, as a decode step finds each
    layer's weights; the zeroing kernel is left out of the sum. Its name
    comes from the same trace (one zeroing, synchronised, before the
    calls: the trace's first device event), since a trace of its own
    may come back empty. ``only``: sum only the kernels whose name holds
    it (one of the call's kernels, without the small ones around it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(2 ** 24, dtype=torch.int32, device="cuda") \
        if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if cold:
                flush.zero_()
                torch.cuda.synchronize()
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        skip = {events[0][2]} if cold and events else set()
        spans = [(start, end) for start, end, name in events
                 if name not in skip and (only is None or only in name)]
        if spans:
            break
    else:
        raise AssertionError("torch.profiler recorded no device time in "
                             f"{PROFILER_TRIES} traces")
    if len(spans) % iters:
        return sum(end - start for start, end in spans) / iters / 1e3
    k = len(spans) // iters
    return statistics.median(
        sum(end - start for start, end in spans[i:i + k])
        for i in range(0, len(spans), k)) / 1e3


def check(out, ref, extra=0.0, atol=ATOL, rtol=RTOL) -> tuple[float, list]:
    """Max abs err, and per leading index (batch row or slot) the worst
    |out - ref| / (atol + rtol |ref| + extra): above 1 fails."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    ratio = diff / (atol + rtol * ref.abs() + extra)
    return diff.max().item(), ratio.flatten(1).amax(1).tolist()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time the card could take: the larger of flops over the bf16
    tensor-core peak and bytes over the HBM rate, in ms."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env() -> tuple[str, dict]:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    env = {"phase": "env", "nvidia_smi": smi_line,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(env)
    return smi_line, env


def phase_build() -> None:
    from gofr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs, "ptxas": _build.build_logs})


def _flash_case(dev, gen, p=4, s=512, lens=(1, 200, 511, 512), d=64,
                hq=32, hkv=8):
    import torch
    q = torch.randn(p, s, hq, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(p, s, hkv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(p, s, hkv, d, generator=gen, device=dev).bfloat16()
    lens = torch.tensor(list(lens), dtype=torch.int32, device=dev)
    return q, k, v, lens


def kernel_flash(dev, gen, wide: bool = False, d128: bool = False,
                 tp2: bool = False) -> dict:
    """The flash kernel at the smoke's P = 4, S = 512 case, or (``wide``)
    at wave 1's widest bucket: one prompt, S = 1024, kv_lengths 901; or
    (``d128``) the P = 4, S = 512 case at Mixtral's head_dim 128, the
    kernel's D = 128 instantiation that ``serve_moe`` launches (its
    launches are read from that phase); or (``tp2``) that case at one
    rank's heads of Llama-3-70B at tp = 2, Hq 32 / Hkv 4 (a GQA group of
    8), which ``serve_tp``'s ranks launch."""
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_plain)
    if wide:
        q, k, v, lens = _flash_case(dev, gen, 1, 1024, (901,))
        name, shape = ("flash_attention_s1024",
                       "P=1 S=1024 Hq=32 Hkv=8 D=64 bf16, kv_lengths 901 "
                       "(wave 1's widest bucket)")
    elif tp2:
        q, k, v, lens = _flash_case(dev, gen, d=128, hkv=4)
        name, shape = ("flash_attention_tp2",
                       "P=4 S=512 Hq=32 Hkv=4 D=128 bf16, kv_lengths "
                       "1/200/511/512 (one rank of Llama-3-70B at tp = 2)")
    elif d128:
        q, k, v, lens = _flash_case(dev, gen, d=128)
        name, shape = ("flash_attention_d128",
                       "P=4 S=512 Hq=32 Hkv=8 D=128 bf16, kv_lengths "
                       "1/200/511/512 (Mixtral-8x7B's heads)")
    else:
        q, k, v, lens = _flash_case(dev, gen)
        name, shape = ("flash_attention", "P=4 S=512 Hq=32 Hkv=8 D=64 bf16, "
                       "kv_lengths 1/200/511/512")
    p, s, hq, d = q.shape
    hkv = k.shape[2]
    out = flash_attention(q, k, v, kv_lengths=lens)
    ref = flash_attention_plain(q, k, v, kv_lengths=lens)
    p_term = P_ROUND * flash_attention_plain(q, k, v.abs(),
                                             kv_lengths=lens).float()
    err, ratios = check(out, ref, p_term)
    if wide:
        # planted fault: V read one row late (row j takes row j - 1's V)
        fault = flash_attention(q, k, torch.roll(v, 1, dims=1),
                                kv_lengths=lens)
        fault_name = "v_rows_shifted"
    else:
        # planted fault: every kv_len above 1 short by one column (for the
        # 512-long row only its last query row sees the change)
        fault = flash_attention(q, k, v, kv_lengths=(lens - 1).clamp(min=1))
        fault_name = "kv_len_short"
    _, fault_ratios = check(fault, ref, p_term)
    emit({"phase": "kernel_check", "name": name,
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "p_round": P_ROUND,
          "worst_ratio_per_row": ratios,
          "planted_fault": fault_name,
          "planted_fault_worst_ratio_per_row": fault_ratios})
    if max(ratios) > 1.0:
        raise AssertionError(f"{name} kernel vs plain: worst err/limit per "
                             f"row {ratios} > 1")
    if any(r <= 1.0 for n, r in zip(lens.tolist(), fault_ratios) if n > 1):
        raise AssertionError(f"{name} check passed a planted fault: "
                             f"{fault_ratios}")
    # the library yardstick: SDPA with GQA expanded and the same mask,
    # built outside the timed call
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    r = torch.arange(s, device=dev)
    mask = ((r[None, :] <= r[:, None])[None]
            & (r[None, None, :] < lens[:, None, None]))[:, None]
    ms = time_ms(lambda: flash_attention(q, k, v, kv_lengths=lens))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v,
                                                     kv_lengths=lens))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    dev_ms = device_ms(lambda: flash_attention(q, k, v, kv_lengths=lens))
    library_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    # flops: 2 products x 2 flops x D per visible (row, col) per q head;
    # row r of batch b sees min(r + 1, kv_len) columns.
    # bytes: q and out once, the K/V rows below kv_len once, lengths.
    lens_l = lens.tolist()
    visible = sum(min(r_ + 1, n) for n in lens_l for r_ in range(s))
    flops = 4.0 * d * hq * visible
    nbytes = (2 * p * s * hq * d * 2 + 2 * sum(min(n, s) for n in lens_l)
              * hkv * d * 2 + 4 * p)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"name": name, "wrapper": "flash_attention", "route": "cuda",
           "source": "gofr_tpu_torch/csrc/flash_attention.cu",
           "replaces": "gofr_tpu/ops/flash_attention.py:33",
           **({"launches_from": "serve_moe"} if d128 else {}),
           **({"launches_from": "serve_tp"} if tp2 else {}),
           "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_device_ms": library_dev_ms}
    emit({"phase": "kernel", "shape": shape, "kernel_ms": ms, **row})
    return row


def _abs_pool(pool):
    """|pool| for either form: a quantized pool keeps its (positive)
    scales and takes |codes|."""
    if isinstance(pool, dict):
        return {"q": pool["q"].abs(), "s": pool["s"]}
    return pool.abs()


def _view_bf16(pool, tables):
    """The gathered slot view in bf16 (an int8 pool dequantized first):
    what the library yardstick reads, built outside its timed call."""
    from gofr_tpu_torch.ops.paged_kv import slot_view
    return slot_view(pool, tables).bfloat16()


def _shift_v_scales(pool):
    """The planted scale fault: each page's V scales moved down one row
    (row r takes row r - 1's scale, row 0 the last row's)."""
    import torch
    return {"q": pool["q"], "s": torch.roll(pool["s"], 1, dims=2)}


def _kv_bytes(rows: int, hkv: int, d: int, quantized: bool) -> int:
    """Bytes of the K and V rows a kernel must read: 2 bf16 bytes per
    element, or 1 per code plus a float32 scale per row."""
    return 2 * rows * hkv * ((d + 4) if quantized else 2 * d)


def _int8_fields(quantized: bool, name: str, replaces: tuple, shape: str):
    """(row name, replaced TPU kernel or branch, shape note) for one pool
    form; ``replaces`` holds the kernel's line and its int8 branch's."""
    if not quantized:
        return name, replaces[0], shape + " bf16"
    return (name + "_int8", replaces[1],
            shape + " int8 {q, s} = quantize_pool of the bf16 pools")


def kernel_paged(dev, gen, lens_l: list, seed: int, shape: str,
                 d: int = 64) -> list:
    """The paged decode kernel, on a bf16 pool and on ``quantize_pool``
    of the same pool: one row each. Llama-3.2-1B heads (``d`` 128:
    Llama-3-8B's, the rows named ``_d128``, their launches read from
    ``serve_llama8b``), 64-row pages, 256 pages, tables as wide as the
    longest slot (OOB-padded)."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import quantize_pool
    b, hq, hkv, pg, n_pages = len(lens_l), 32, 8, 64, 256
    mp = -(-max(lens_l) // pg)
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages,
                          generator=torch.Generator().manual_seed(seed))
    used = 0
    for i, n in enumerate(lens_l):
        need = -(-n // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    tables = tables.to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    kp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    return [_paged_row(q, kp, vp, tables, lens, pg, shape),
            _paged_row(q, quantize_pool(kp), quantize_pool(vp), tables, lens,
                       pg, shape)]


def _d128_fields(name: str, d: int) -> dict:
    """A D = 128 row's name suffix and where its launches come from:
    ``serve_llama8b``, the phase that serves Llama-3-8B's heads; the
    wrapper's counter keeps the D = 64 row's key."""
    if d == 64:
        return {"name": name}
    return {"name": f"{name}_d{d}", "wrapper": name,
            "launches_from": "serve_llama8b"}


def _paged_row(q, kp, vp, tables, lens, pg, shape) -> dict:
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.paged_attention import (
        kv_splits, paged_decode_attention, paged_decode_attention_plain)
    quantized = isinstance(kp, dict)
    b, hq, d = q.shape
    hkv, mp = (kp["q"] if quantized else kp).shape[0], tables.shape[1]
    lens_l = lens.tolist()
    name, replaces, shape = _int8_fields(
        quantized, "paged_decode_attention",
        ("gofr_tpu/ops/paged_attention.py:134",
         "gofr_tpu/ops/paged_attention.py:138"), shape)
    fields = _d128_fields(name, d)
    name = fields["name"]
    out = paged_decode_attention(q, kp, vp, tables, lens)
    ref = paged_decode_attention_plain(q, kp, vp, tables, lens)
    err, ratios = check(out, ref)
    # planted fault: each slot longer than a page loses the rows of its
    # partial last page (65 -> 64, 300 -> 256, 1000 -> 960, 1500 -> 1472)
    cut = torch.where(lens > pg, lens - lens % pg, lens)
    fault = paged_decode_attention(q, kp, vp, tables, cut)
    _, fault_ratios = check(fault, ref)
    faults = {"tail_page": fault_ratios}
    if quantized:
        # planted scale fault: V scales shifted one row within each page
        shifted = paged_decode_attention(q, kp, _shift_v_scales(vp), tables,
                                         lens)
        faults["v_scales_shifted"] = check(shifted, ref)[1]
    emit({"phase": "kernel_check", "name": name,
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "worst_ratio_per_slot": ratios,
          **{f"planted_fault_{k}_worst_ratio_per_slot": v
             for k, v in faults.items()}})
    empty_zero = all(out[i].abs().max().item() == 0.0
                     for i, n in enumerate(lens_l) if n == 0)
    if max(ratios) > 1.0 or not empty_zero:
        raise AssertionError(f"{name} kernel vs plain: worst err/limit per "
                             f"slot {ratios} > 1, or a zero-length slot is "
                             f"not exactly zero")
    if any(r <= 1.0 for a, b_, r in zip(lens_l, cut.tolist(), fault_ratios)
           if a != b_):
        raise AssertionError(f"{name} check passed a planted tail-page "
                             f"fault: {fault_ratios}")
    if quantized and any(r <= 1.0 for n, r in zip(
            lens_l, faults["v_scales_shifted"]) if n):
        raise AssertionError(f"{name} check passed a planted V-scale fault: "
                             f"{faults['v_scales_shifted']}")
    # library yardstick: SDPA on the gathered view (an int8 pool
    # dequantized beforehand, untimed), GQA expanded
    view_k = _view_bf16(kp, tables).repeat_interleave(hq // hkv, dim=2)
    view_v = _view_bf16(vp, tables).repeat_interleave(hq // hkv, dim=2)
    kt = view_k.transpose(1, 2).contiguous()
    vt = view_v.transpose(1, 2).contiguous()
    mask = (torch.arange(mp * pg, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, tables, lens))
    plain_ms = time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, tables, lens))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=mask))
    dev_ms = device_ms(lambda: paged_decode_attention(q, kp, vp, tables,
                                                      lens))
    library_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=mask))
    # bytes: K and V rows below each length (bf16: 2·len·hd·2 per KV
    # head; int8: 2·len·(hd + 4)), q, out, the table entries walked,
    # lengths; flops: 4·hd per row per q head
    nbytes = (sum(_kv_bytes(n, hkv, d, quantized) for n in lens_l)
              + 2 * b * hq * d * 2
              + sum(-(-n // pg) for n in lens_l) * 4 + 4 * b)
    flops = sum(4.0 * n * hq * d for n in lens_l)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {**fields, "route": "cuda",
           "source": "gofr_tpu_torch/csrc/paged_decode.cu",
           "replaces": replaces,
           "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_device_ms": library_dev_ms,
           "splits": kv_splits("decode", b, 1, hq, hkv, mp, pg)}
    if quantized:
        row["library_note"] = ("SDPA on the gathered view dequantized to "
                               "bf16 beforehand (dequantization not timed)")
    emit({"phase": "kernel", "shape": shape, "kernel_ms": ms, **row})
    return row


def kernel_chunk(dev, gen, group3: bool = False, d: int = 64) -> list:
    """The paged chunk kernel, on a bf16 pool and on ``quantize_pool``
    of the same pool: one row each; with ``group3`` one bf16 row at GQA
    group 3 (12 query heads over 4 KV heads: 21-position tiles of 63
    live rows in the 64-row block); ``d`` 128: at Llama-3-8B's head
    dimension (rows ``_d128``)."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import quantize_pool
    # the serve path's shapes: llama3_1b heads, 64-row pages, tables of
    # max_seq 2048 / 64 = 32 pages padded with the OOB id, a 1024-row
    # chunk (the widest bucket); (history, chunk) per slot: a fresh
    # prompt, the second chunk of an 1801-token walk, a prefix-cache
    # suffix of 6 rows after 896 cached rows, an empty pad row
    sq, hq, hkv, pg, n_pages, mp = 1024, 32, 8, 64, 128, 32
    if group3:
        hq, hkv = 12, 4
    hists, clens = [0, 1024, 896, 0], [1024, 777, 6, 0]
    b = len(hists)
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(3))
    used = 0
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    # planted fault: each slot's last history page swapped for a page no
    # slot holds
    bad = tables.clone()
    for i, h in enumerate(hists):
        if h:
            bad[i, (h - 1) // pg] = int(perm[used + i])
    tables, bad = tables.to(dev), bad.to(dev)
    q = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
    kp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    hist = torch.tensor(hists, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    if group3:
        return [_chunk_row(q, kp, vp, tables, bad, hist, clen, pg)]
    return [_chunk_row(q, kp, vp, tables, bad, hist, clen, pg),
            _chunk_row(q, quantize_pool(kp), quantize_pool(vp), tables, bad,
                       hist, clen, pg)]


def _chunk_row(q, kp, vp, tables, bad, hist, clen, pg) -> dict:
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.paged_attention import (
        kv_splits, paged_chunk_attention, paged_chunk_attention_plain)
    quantized = isinstance(kp, dict)
    b, sq, hq, d = q.shape
    hkv, mp = (kp["q"] if quantized else kp).shape[0], tables.shape[1]
    hists, clens = hist.tolist(), clen.tolist()
    name, replaces, shape = _int8_fields(
        quantized, "paged_chunk_attention",
        ("gofr_tpu/ops/paged_attention.py:357",
         "gofr_tpu/ops/paged_attention.py:362"),
        f"B=4 Sq=1024 Hq={hq} Hkv={hkv} hd={d} pg=64 Np=128 Mp=32, (history, "
        "chunk) (0, 1024) (1024, 777) (896, 6) (0, 0), OOB-padded tables,")
    fields = _d128_fields(name, d)
    fields["wrapper"] = name
    if hq // hkv != 4:
        fields["name"] = f"{name}_group{hq // hkv}"
    name = fields["name"]
    args = (q, kp, vp, tables, hist, clen)
    out = paged_chunk_attention(*args)
    ref = paged_chunk_attention_plain(*args)
    # the kernel rounds P (times the V row scale, for int8) to bf16 as
    # flash does: same per-element limit, over the dequantized |V|
    p_term = P_ROUND * paged_chunk_attention_plain(
        q, kp, _abs_pool(vp), tables, hist, clen).float()
    err, ratios = check(out, ref, p_term)
    fault = paged_chunk_attention(q, kp, vp, bad, hist, clen)
    faults = {"history_page": check(fault, ref, p_term)[1]}
    if quantized:
        shifted = paged_chunk_attention(q, kp, _shift_v_scales(vp), tables,
                                        hist, clen)
        faults["v_scales_shifted"] = check(shifted, ref, p_term)[1]
    padding = torch.arange(sq, device=q.device)[None, :] >= clen[:, None]
    pad_finite = bool(torch.isfinite(out[padding].float()).all().item())
    empty_zero = out[3].abs().max().item() == 0.0
    emit({"phase": "kernel_check", "name": name,
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "p_round": P_ROUND, "worst_ratio_per_slot": ratios,
          **{f"planted_fault_{k}_worst_ratio_per_slot": v
             for k, v in faults.items()},
          "padding_rows_finite": pad_finite,
          "empty_slot_exact_zeros": empty_zero})
    if max(ratios) > 1.0 or not pad_finite or not empty_zero:
        raise AssertionError(f"{name} kernel vs plain: worst err/limit "
                             f"per slot {ratios} > 1, padding finite "
                             f"{pad_finite}, empty slot zero {empty_zero}")
    if any(r <= 1.0 for h, r in zip(hists, faults["history_page"]) if h):
        raise AssertionError(f"{name} check passed a planted history-page "
                             f"fault: {faults['history_page']}")
    if quantized and any(r <= 1.0 for c, r in zip(
            clens, faults["v_scales_shifted"]) if c):
        raise AssertionError(f"{name} check passed a planted V-scale fault: "
                             f"{faults['v_scales_shifted']}")
    # library yardstick: SDPA on the gathered view (an int8 pool
    # dequantized beforehand), GQA expanded and the same visibility as a
    # boolean mask, all built outside the timed call
    group = hq // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = _view_bf16(kp, tables).repeat_interleave(group, dim=2) \
        .transpose(1, 2).contiguous()
    vt = _view_bf16(vp, tables).repeat_interleave(group, dim=2) \
        .transpose(1, 2).contiguous()
    pos = torch.arange(mp * pg, device=q.device)[None, None, :]
    q_pos = (hist[:, None]
             + torch.arange(sq, device=q.device)[None, :])[:, :, None]
    mask = ((pos <= q_pos) & (pos < (hist + clen)[:, None, None]))[:, None]
    ms = time_ms(lambda: paged_chunk_attention(*args))
    plain_ms = time_ms(lambda: paged_chunk_attention_plain(*args))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    dev_ms = device_ms(lambda: paged_chunk_attention(*args))
    library_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    # flops: 4·hd per visible (row, position) per q head; chunk row i of
    # slot b sees history + i + 1 positions (within the table).
    # bytes: the q rows of each chunk once, all of out once, the K/V rows
    # of history + chunk once, the table entries walked, both lengths.
    visible = sum(min(h + i + 1, mp * pg) for h, c in zip(hists, clens)
                  for i in range(c))
    flops = 4.0 * d * hq * visible
    kv_rows = [min(h + c, mp * pg) for h, c in zip(hists, clens)]
    nbytes = (sum(clens) * hq * d * 2 + b * sq * hq * d * 2
              + sum(_kv_bytes(n, hkv, d, quantized) for n in kv_rows)
              + sum(-(-n // pg) for n in kv_rows) * 4 + 8 * b)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {**fields, "route": "cuda",
           "source": "gofr_tpu_torch/csrc/paged_chunk.cu",
           "replaces": replaces,
           "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_device_ms": library_dev_ms,
           "splits": kv_splits("chunk", b, sq, hq, hkv, mp, pg)}
    if quantized:
        row["library_note"] = ("SDPA on the gathered view dequantized to "
                               "bf16 beforehand (dequantization not timed)")
    emit({"phase": "kernel", "shape": shape, "kernel_ms": ms, **row})
    return row


def _tree_slots():
    """The tree kernel's serving-shape case: per slot a history and a
    draft tree from ``build_draft_tree`` (None: an empty slot), with the
    chunk length each slot feeds."""
    from gofr_tpu_torch.serving.spec import build_draft_tree
    fresh = iter(range(1000, 2000))        # distinct draft tokens

    def chain(n):
        return [next(fresh) for _ in range(n)]

    shared, first = chain(2), chain(1)
    wide = build_draft_tree(1, [chain(4), chain(4)])        # 1 + 4 x 2
    slots = [
        (0, None, 0),                                        # empty slot
        (1, build_draft_tree(1, [shared + chain(2), shared + chain(2)]),
         None),                            # 2 branches, shared prefix
        (63, build_draft_tree(1, [chain(2) for _ in range(4)]), None),
        (64, build_draft_tree(1, [chain(4)]), None),         # a chain
        (65, wide, 6),                     # a topological prefix
        (1500, build_draft_tree(1, [chain(4), chain(4)]), None),
        (300, build_draft_tree(1, []), None),                # lone root
        (1000, build_draft_tree(1, [first + chain(3), first + chain(3)]),
         None),
    ]
    return [(h, t, t.n_nodes if c is None and t is not None else (c or 0))
            for h, t, c in slots]


def _tree_slot_b1():
    """One request's verify over a long history: a 1 + 4 x 2 draft tree
    after 1900 history rows."""
    from gofr_tpu_torch.serving.spec import build_draft_tree
    tree = build_draft_tree(1, [list(range(1000, 1004)),
                                list(range(1004, 1008))])
    return [(1900, tree, tree.n_nodes)]


def _poison_fork(tree, clen):
    """The last node (below ``clen``) whose parent has an earlier child:
    the root of a sibling branch, or None for a chain."""
    forks = [j for j in range(1, clen)
             if any(tree.parents[i] == tree.parents[j] for i in range(1, j))]
    return forks[-1] if forks else None


def kernel_tree(dev, gen, slots: list, seed: int, shape: str,
                chain_slot: int | None, d: int = 64) -> list:
    """The paged tree kernel, on a bf16 pool and on ``quantize_pool`` of
    the same pool: one row each. ``chain_slot``: a slot whose tree is a
    chain, held bit for bit against the chunk kernel. ``d`` 128: at
    Llama-3-8B's head dimension (rows ``_d128``)."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import quantize_pool
    # the verify pass's shapes: width 16 (the pow-2 bucket of a 1 + 4 x 2
    # tree), llama3_1b heads, 64-row pages, tables of 32 pages
    w, hq, hkv, pg, n_pages, mp = 16, 32, 8, 64, 256, 32
    b = len(slots)
    hists = [h for h, _, _ in slots]
    clens = [c for _, _, c in slots]
    masks = torch.ones(b, w, dtype=torch.int32)
    for i, (_, tree, _) in enumerate(slots):
        if tree is not None:
            masks[i, :tree.n_nodes] = torch.tensor(tree.masks,
                                                   dtype=torch.int32)
    # planted fault: the causal chunk masks (row i sees rows 0..i)
    causal = torch.cumsum(1 << torch.arange(w), 0).to(torch.int32)
    causal = causal[None].expand(b, w).contiguous()
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages,
                          generator=torch.Generator().manual_seed(seed))
    used = 0
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    tables, masks, causal = tables.to(dev), masks.to(dev), causal.to(dev)
    q = torch.randn(b, w, hq, d, generator=gen, device=dev).bfloat16()
    kp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    hist = torch.tensor(hists, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    case = (tables, hist, clen, masks, causal, slots, pg, shape, chain_slot)
    return [_tree_row(q, kp, vp, *case),
            _tree_row(q, quantize_pool(kp), quantize_pool(vp), *case)]


def _poisoned(pool, rows, value: float):
    """A copy of ``pool`` whose (page, offset) ``rows`` hold ``value`` in
    every element (an int8 pool: codes ±127 at scale |value| / 127)."""
    import torch
    if isinstance(pool, dict):
        out = {k: t.clone() for k, t in pool.items()}
        for pid, off in rows:
            out["q"][:, pid, off] = 127 if value > 0 else -127
            out["s"][:, pid, off] = abs(value) / 127.0
        return out
    out = pool.clone()
    for pid, off in rows:
        out[:, pid, off] = torch.tensor(value, dtype=out.dtype)
    return out


def _tree_row(q, kp, vp, tables, hist, clen, masks, causal, slots, pg,
              shape, chain_slot) -> dict:
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.paged_attention import (
        kv_splits, paged_chunk_attention, paged_tree_attention,
        paged_tree_attention_plain)
    quantized = isinstance(kp, dict)
    b, w, hq, d = q.shape
    hkv, mp = (kp["q"] if quantized else kp).shape[0], tables.shape[1]
    hists, clens = hist.tolist(), clen.tolist()
    name, replaces, shape = _int8_fields(
        quantized, "paged_tree_attention",
        ("gofr_tpu/ops/paged_attention.py:614",
         "gofr_tpu/ops/paged_attention.py:619"),
        f"{shape}, chunks {clens}, OOB-padded tables,")
    fields = _d128_fields(name, d)
    name = fields["name"]
    args = (q, kp, vp, tables, hist, clen)
    out = paged_tree_attention(*args, masks)
    ref = paged_tree_attention_plain(*args, masks)
    # the kernel rounds P (times the V row scale, for int8) to bf16 as
    # the chunk kernel does: same limit, over the dequantized |V|
    p_term = P_ROUND * paged_tree_attention_plain(
        q, kp, _abs_pool(vp), tables, hist, clen, masks).float()
    err, ratios = check(out, ref, p_term)
    fault = paged_tree_attention(*args, causal)
    fault_ratios = check(fault, ref, p_term)[1]
    shifted_ratios = None
    if quantized:
        shifted = paged_tree_attention(q, kp, _shift_v_scales(vp), tables,
                                       hist, clen, masks)
        shifted_ratios = check(shifted, ref, p_term)[1]
    branching = [i for i, (_, t, c) in enumerate(slots)
                 if t is not None and _poison_fork(t, c) is not None]
    empty_zero = all(out[i].abs().max().item() == 0.0
                     for i, c in enumerate(clens) if c == 0)
    # chain check: a chain's masks are the causal ones, so the chunk
    # kernel on the same inputs is the reference; with causal masks in
    # every slot the two kernels run the same walk (the same splits)
    chunk = paged_chunk_attention(*args)
    causal_bitwise = bool(torch.equal(fault, chunk))
    chain_ratios, chain_bitwise = [0.0], True
    if chain_slot is not None:
        i = chain_slot
        _, chain_ratios = check(out[i:i + 1], chunk[i:i + 1].float(),
                                p_term[i:i + 1])
        chain_bitwise = bool(torch.equal(out[i], chunk[i]))
    # invariance: poison each branching slot's last sibling branch (its
    # K and V rows) with large finite values; every node that does not
    # descend from it must come back bit for bit the same
    poison_rows = []
    keep_rows = {}
    tab = tables.cpu()
    for i in branching:
        tree, c = slots[i][1], clens[i]
        fork = _poison_fork(tree, c)
        for j in range(c):
            pos = hists[i] + j
            if (tree.masks[j] >> fork) & 1:
                poison_rows.append((int(tab[i, pos // pg]), pos % pg))
        keep_rows[i] = [j for j in range(c) if not (tree.masks[j] >> fork) & 1]
    poisoned = paged_tree_attention(q, _poisoned(kp, poison_rows, 3e4),
                                    _poisoned(vp, poison_rows, -3e4), tables,
                                    hist, clen, masks)
    unchanged = {i: bool(torch.equal(poisoned[i, rows], out[i, rows]))
                 for i, rows in keep_rows.items()}
    poison_finite = bool(torch.isfinite(poisoned.float()).all().item())
    emit({"phase": "kernel_check", "name": name,
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "p_round": P_ROUND, "worst_ratio_per_slot": ratios,
          "planted_fault": "causal chunk masks in place of the tree masks",
          "planted_fault_worst_ratio_per_slot": fault_ratios,
          **({"planted_fault_v_scales_shifted_worst_ratio_per_slot":
              shifted_ratios} if quantized else {}),
          "branching_slots": branching,
          "empty_slot_exact_zeros": empty_zero,
          "chain_slot_vs_chunk_kernel_worst_ratio": chain_ratios[0],
          "chain_slot_bitwise_equal_to_chunk_kernel": chain_bitwise,
          "causal_masks_bitwise_equal_to_chunk_kernel": causal_bitwise,
          "sibling_poison_non_descendants_bitwise_unchanged": unchanged,
          "sibling_poison_output_finite": poison_finite})
    if max(ratios) > 1.0 or not empty_zero or chain_ratios[0] > 1.0:
        raise AssertionError(f"{name} kernel vs plain: worst err/limit "
                             f"per slot {ratios} > 1, chain vs chunk kernel "
                             f"{chain_ratios}, empty slot zero {empty_zero}")
    if any(fault_ratios[i] <= 1.0 for i in branching):
        raise AssertionError(f"{name} check passed a planted causal-mask "
                             f"fault: {fault_ratios}")
    if quantized and any(r <= 1.0 for c, r in zip(clens, shifted_ratios)
                         if c):
        raise AssertionError(f"{name} check passed a planted V-scale fault: "
                             f"{shifted_ratios}")
    if not all(unchanged.values()) or not poison_finite:
        raise AssertionError(f"{name}: poisoning a sibling branch moved "
                             f"other nodes: {unchanged}")
    if not chain_bitwise or not causal_bitwise:
        raise AssertionError(f"{name}: not bit for bit the chunk kernel "
                             f"(chain slot {chain_bitwise}, causal masks "
                             f"{causal_bitwise})")
    # library yardstick: SDPA on the gathered view (an int8 pool
    # dequantized beforehand), GQA expanded, the tree visibility as a
    # boolean mask, all built outside the timed call
    group = hq // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = _view_bf16(kp, tables).repeat_interleave(group, dim=2) \
        .transpose(1, 2).contiguous()
    vt = _view_bf16(vp, tables).repeat_interleave(group, dim=2) \
        .transpose(1, 2).contiguous()
    pos = torch.arange(mp * pg, device=q.device)[None, None, :]
    rel = pos - hist[:, None, None]
    bit = (masks[:, :, None] >> rel.clamp(0, 31)) & 1
    mask = ((rel < 0) | ((rel < clen[:, None, None]) & (bit == 1)))[:, None]
    ms = time_ms(lambda: paged_tree_attention(*args, masks))
    plain_ms = time_ms(lambda: paged_tree_attention_plain(*args, masks))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    dev_ms = device_ms(lambda: paged_tree_attention(*args, masks))
    library_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    # flops: 4·hd per visible (node, position) per q head; node i of
    # slot b sees the history and popcount(mask_i) tree rows.
    # bytes: the live q rows once, all of out once, the K/V rows of
    # history + chunk once, the table entries walked, both lengths, and
    # the live nodes' masks.
    m_cpu = masks.cpu().tolist()
    visible = sum(h + bin(m_cpu[i][j] & 0xFFFFFFFF).count("1")
                  for i, (h, c) in enumerate(zip(hists, clens))
                  for j in range(c))
    flops = 4.0 * d * hq * visible
    kv_rows = [h + c for h, c in zip(hists, clens)]
    nbytes = (sum(clens) * hq * d * 2 + b * w * hq * d * 2
              + sum(_kv_bytes(n, hkv, d, quantized) for n in kv_rows)
              + sum(-(-n // pg) for n in kv_rows) * 4 + 8 * b
              + sum(clens) * 4)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {**fields, "route": "cuda",
           "source": "gofr_tpu_torch/csrc/paged_chunk.cu",
           "replaces": replaces,
           "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_device_ms": library_dev_ms,
           "splits": kv_splits("tree", b, w, hq, hkv, mp, pg)}
    if quantized:
        row["library_note"] = ("SDPA on the gathered view dequantized to "
                               "bf16 beforehand (dequantization not timed)")
    emit({"phase": "kernel", "shape": shape, "kernel_ms": ms, **row})
    return row


def _clone_pool(pool):
    return ({k: t.clone() for k, t in pool.items()}
            if isinstance(pool, dict) else pool.clone())


def _pool_leaves(pool) -> list:
    return [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]


def _pools_diff(got, want) -> tuple[float, bool]:
    """(max |got - want| over every leaf of both pools, bit-equal)."""
    import torch
    pairs = list(zip(_pool_leaves(got[0]) + _pool_leaves(got[1]),
                     _pool_leaves(want[0]) + _pool_leaves(want[1])))
    return (max((g.float() - w.float()).abs().max().item()
                for g, w in pairs),
            all(torch.equal(g, w) for g, w in pairs))


def _library_write(k_pool, v_pool, pids, offs, k_rows, v_rows, li=None):
    """The nearest library path of a K/V row write (no single PyTorch
    call selects, quantizes and scatters paged rows): the in-range rows
    selected, and for an int8 pool quantized, beforehand and untimed, then
    one ``index_copy_`` per pool leaf into its ``[.., Hkv, Np·pg, w]``
    view, of layer ``li`` (rows [N, Hkv, hd]) or with ``li`` None of
    every layer (a slab [L, P, S, Hkv, hd]). Returns the timed call."""
    from gofr_tpu_torch.ops.paged_kv import (is_quantized_pool, keep_index,
                                             pool_shape, quantize_rows)
    n_layers, hkv, n_pages, pg, d = pool_shape(k_pool)
    keep = keep_index(pids, n_pages, offs, pg)
    idx = (pids.reshape(-1)[keep].long() * pg
           + offs.reshape(-1)[keep].long())
    copies = []
    for pool, rows in ((k_pool, k_rows), (v_pool, v_rows)):
        if li is None:                                  # [L, Hkv, n, hd]
            sel = rows.reshape(n_layers, -1, hkv, d)[:, keep].transpose(1, 2)
        else:                                           # [Hkv, n, hd]
            sel = rows.reshape(-1, hkv, d)[keep].transpose(0, 1)
        srcs = quantize_rows(sel) if is_quantized_pool(pool) else (sel,)
        for leaf, src in zip(_pool_leaves(pool), srcs):
            view = leaf if li is None else leaf[li]
            copies.append((view.reshape(*view.shape[:-3], n_pages * pg,
                                        view.shape[-1]),
                           src.to(leaf.dtype).contiguous()))
    dim = 1 if li is not None else 2

    def call():
        for view, src in copies:
            view.index_copy_(dim, idx, src)
    return call


def _write_bytes(n_layers, live, hkv, d, quantized) -> int:
    """Bytes a K/V write must move: the live K and V rows read once and
    written once (int8: hd codes and a float32 scale a row and head)."""
    row_bytes = hkv * ((d + 4) if quantized else 2 * d)
    return n_layers * 2 * live * (hkv * d * 2 + row_bytes)


def kernel_kv_write(dev, gen) -> list:
    """The per-layer KV write entry at a decode step's shape on the serve
    pool (16 layers, Hkv 8, hd 64, 256 pages of 64 rows): 8 rows, 5 of
    them in range and 3 dropped (page ids Np, Np and -1), into layer 7;
    one row per pool form. Since the fused RoPE entry took the model
    steps' write, the main path no longer launches this entry
    (``pool_write`` and ``scatter_chunk`` still do): its rows stay as the
    entry's check and yardstick. The kernel's pools must equal its plain
    version's bit for bit (int8 codes and scales too). Planted faults:
    the bf16 rows written one offset late, and for int8 the kernel's V
    scales shifted one row within each page; each must fail the same
    check. ``library_ms``: the nearest library path, ``index_copy_`` of
    the in-range rows (selected, quantized, beforehand)."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import (kv_write, kv_write_plain,
                                             quantize_pool)
    n_layers, hkv, d, n_pages, pg, li = 16, 8, 64, 256, 64, 7
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    pids = torch.tensor([17, 3, n_pages, 200, -1, 64, n_pages, 9],
                        dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 63, 5, 21, 7, 40, 2, 33], dtype=torch.int32,
                        device=dev)
    n, live = len(pids), int(((pids >= 0) & (pids < n_pages)).sum())
    k_rows = torch.randn(n, hkv, d, generator=gen, device=dev).bfloat16()
    v_rows = torch.randn(n, hkv, d, generator=gen, device=dev).bfloat16()

    rows = []
    for quantized in (False, True):
        kp, vp = ((quantize_pool(k_pool), quantize_pool(v_pool)) if quantized
                  else (k_pool, v_pool))
        name = "kv_write_int8" if quantized else "kv_write"
        want = kv_write_plain(_clone_pool(kp), _clone_pool(vp), li, pids,
                              offs, k_rows, v_rows)
        got = kv_write(_clone_pool(kp), _clone_pool(vp), li, pids, offs,
                       k_rows, v_rows)
        lib = (_clone_pool(kp), _clone_pool(vp))
        _library_write(*lib, pids, offs, k_rows, v_rows, li)()
        torch.cuda.synchronize()
        err, equal = _pools_diff(got, want)
        if quantized:
            fault_name = "v_scales_shifted"
            fault = (got[0], {"q": got[1]["q"],
                              "s": torch.roll(got[1]["s"], 1, dims=3)})
        else:
            fault_name = "rows_one_offset_late"
            fault = kv_write(_clone_pool(kp), _clone_pool(vp), li, pids,
                             (offs + 1) % pg, k_rows, v_rows)
        fault_err, fault_equal = _pools_diff(fault, want)
        emit({"phase": "kernel_check", "name": name, "max_abs_err": err,
              "bit_equal": equal, "planted_fault": fault_name,
              "planted_fault_max_abs_err": fault_err,
              "planted_fault_bit_equal": fault_equal,
              "library_path_bit_equal": _pools_diff(lib, want)[1]})
        if not equal:
            raise AssertionError(f"{name}: kernel pools differ from the "
                                 f"plain version's (max abs {err})")
        if fault_equal:
            raise AssertionError(f"{name} check passed a planted fault "
                                 f"({fault_name})")
        dst = (_clone_pool(kp), _clone_pool(vp))
        library = _library_write(*dst, pids, offs, k_rows, v_rows, li)
        ms = time_ms(lambda: kv_write(*dst, li, pids, offs, k_rows, v_rows))
        plain_ms = time_ms(lambda: kv_write_plain(*dst, li, pids, offs,
                                                  k_rows, v_rows))
        lib_ms = time_ms(library)
        dev_ms = device_ms(lambda: kv_write(*dst, li, pids, offs, k_rows,
                                            v_rows))
        lib_dev_ms = device_ms(library)
        bound_ms, bound_by = bound(0.0, _write_bytes(1, live, hkv, d,
                                                     quantized) + 8 * n)
        row = {"name": name, "route": "cuda",
               "source": "gofr_tpu_torch/csrc/kv_write.cu",
               "replaces": "gofr_tpu/ops/paged_kv.py:124",
               "replaces_note": "pool_write: XLA's scatter (.at[].set, "
                                "mode='drop', quantize_rows for int8), "
                                "not a pallas_call",
               "main_path": "no: pool_write and scatter_chunk only, "
                            "the model steps write through rope_kv_write",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms,
               "library_note": "no single library call; nearest path: "
                               "index_copy_ of the in-range K and V rows "
                               "(selected" + (", quantized" if quantized
                                              else "")
                               + " beforehand, untimed)"}
        emit({"phase": "kernel", "shape": f"N={n} rows ({live} in range) "
              f"L={n_layers} Hkv={hkv} hd={d} Np={n_pages} pg={pg}, layer "
              f"{li}, " + ("int8 {q, s}" if quantized else "bf16"),
              "kernel_ms": ms, **row})
        rows.append(row)
    return rows


#: Llama-3.2's rope_scaling (its checkpoints' config.json)
LLAMA32_SCALING = {"factor": 32.0, "low_freq_factor": 1.0,
                   "high_freq_factor": 4.0, "original_max_position": 8192}


def _verify_coords(dev, gen, n_pages, pg):
    """A speculative verify's rows on the serve pool: 8 slots x 16 tree
    nodes, histories 0/1/63/64/65/1500/300/1000 rows; slot 6 verifies 9
    nodes (the rest padding) and slot 7 is idle (all-OOB table). Node i
    of slot b is RoPE'd at ``history + depth[i]`` and written at row
    ``history + i`` through the slot's table, as
    ``llama_prefill_chunk_paged`` computes them in tree mode. Returns
    (positions, page ids, offsets), each int32 [8, 16]."""
    import torch
    b, w, mp = 8, 16, 32
    hist = torch.tensor([0, 1, 63, 64, 65, 1500, 300, 1000], device=dev)
    clen = torch.tensor([16] * 6 + [9, 0], device=dev)
    depth = torch.tensor([0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7],
                         device=dev)
    tables = torch.full((b, mp), n_pages, dtype=torch.int32, device=dev)
    pages = torch.randperm(n_pages, generator=gen, device=dev).int()
    used = 0
    for i in range(b - 1):
        need = -(-(int(hist[i]) + w) // pg)
        tables[i, :need] = pages[used:used + need]
        used += need
    node = hist[:, None] + torch.arange(w, device=dev)[None, :]
    valid = torch.arange(w, device=dev)[None, :] < clen[:, None]
    pids = torch.gather(tables, 1, (node // pg).clamp(0, mp - 1))
    pids = torch.where(valid & (node < mp * pg), pids,
                       torch.full_like(pids, n_pages))
    return ((hist[:, None] + depth[None, :]).int(), pids.int(),
            (node % pg).int())


def kernel_rope_kv_write(dev, gen, verify: bool, d: int = 64) -> list:
    """The fused RoPE + K/V write entry (``rope_kv_write``) at the shape
    the main path gives it, on the serve pool (16 layers, Hkv 8, hd 64,
    256 pages of 64 rows, Hq 32), layer 7, one row per pool form: a
    decode step (``verify`` False: kernel_kv_write's 8 rows, 3 dropped,
    at positions 0-2047, plain RoPE) or a speculative verify (8 slots x
    16 nodes, RoPE at the node's depth and the row at its index, one slot
    padded, one idle; Llama-3.2's ``rope_scaling``). The rotated q and
    both pools (int8 codes and scales too) must equal
    ``rope_kv_write_plain``'s bit for bit. Planted faults, each must fail
    the same check: the positions one late, the rotate-half sign flipped
    (the kernel fed ``-inv_freq``: cos is even, sin odd), and for int8 the
    amax taken before the bf16 rounding (the plain pools with each K
    row's scale from the float32 rotation's amax, its codes from the
    rounded values under that scale). Times: the kernel, the plain
    version, the unfused path (``apply_rope`` x 2 + the ``kv_write``
    kernel, ``unfused_path_*``) and, as ``library_ms``, ``index_copy_`` of
    the rotated rows (RoPE, selection and quantize beforehand,
    untimed). ``d`` 128: the decode step's rows at Llama-3-8B's shape (32
    layers, hd 128; rows ``_d128``, launches from ``serve_llama8b``)."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import (keep_index, kv_write,
                                             quantize_pool, rope_kv_write,
                                             rope_kv_write_plain)
    from gofr_tpu_torch.ops.rope import apply_rope, rope_frequencies
    n_layers, hq, hkv, n_pages, pg, li = 16, 32, 8, 256, 64, 7
    if d == 128:
        n_layers = 32
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    if verify:
        positions, pids, offs = _verify_coords(dev, gen, n_pages, pg)
        scaling, lead = LLAMA32_SCALING, (8, 16)
    else:
        positions = torch.tensor([0, 2047, 1500, 63, 64, 901, 7, 1024],
                                 dtype=torch.int32, device=dev)
        pids = torch.tensor([17, 3, n_pages, 200, -1, 64, n_pages, 9],
                            dtype=torch.int32, device=dev)
        offs = positions % pg
        scaling, lead = None, (8,)
    inv_freq = rope_frequencies(d, 500000.0, scaling, device=dev)
    n = pids.numel()
    live = int(((pids >= 0) & (pids < n_pages)).sum())
    q, k, v = (torch.randn(*lead, h, d, generator=gen, device=dev)
               .bfloat16() for h in (hq, hkv, hkv))

    def run(fn, kp, vp, pos=positions, inv=inv_freq):
        pools = (_clone_pool(kp), _clone_pool(vp))
        q_rot = fn(q, k, v, pos, inv, *pools, li, pids, offs)
        torch.cuda.synchronize()
        return q_rot, pools

    def unfused_path(kp, vp):
        kv_write(kp, vp, li, pids, offs, apply_rope(k, positions, inv_freq),
                 v)
        return apply_rope(q, positions, inv_freq)

    rows = []
    for quantized in (False, True):
        kp, vp = ((quantize_pool(k_pool), quantize_pool(v_pool)) if quantized
                  else (k_pool, v_pool))
        form = "_int8" if quantized else ""
        fields = _d128_fields(
            "rope_kv_write" + ("_verify" if verify else "") + form, d)
        name = fields["name"]
        want_q, want = run(rope_kv_write_plain, kp, vp)
        got_q, got = run(rope_kv_write, kp, vp)
        err, equal = _pools_diff(got, want)
        err = max(err, (got_q.float() - want_q.float()).abs().max().item())
        equal = equal and torch.equal(got_q, want_q)
        faults = {"positions_one_late": run(rope_kv_write, kp, vp,
                                            positions + 1),
                  "rotate_half_sign_flipped": run(rope_kv_write, kp, vp,
                                                  inv=-inv_freq)}
        if quantized:
            # the K rows' scales from the float32 rotation's amax, their
            # codes from the bf16-rounded values under those scales
            rot = apply_rope(k.float(), positions, inv_freq)
            amax = rot.abs().amax(-1, keepdim=True).clamp(min=1e-8)
            scale = amax / torch.full_like(amax, 127.0)
            codes = torch.round(rot.bfloat16().float() / scale).clamp(
                -127, 127).to(torch.int8)
            pools = (_clone_pool(want[0]), _clone_pool(want[1]))
            keep = keep_index(pids, n_pages, offs, pg)
            at = (slice(None), pids.reshape(-1)[keep].long(),
                  offs.reshape(-1)[keep].long())
            for leaf, val in ((pools[0]["q"], codes), (pools[0]["s"], scale)):
                leaf[li][at] = val.reshape(n, hkv, -1)[keep].transpose(0, 1)
            faults["amax_before_bf16_rounding"] = (want_q, pools)
        fault_equal = {f: torch.equal(fq, want_q) and _pools_diff(fp, want)[1]
                       for f, (fq, fp) in faults.items()}
        emit({"phase": "kernel_check", "name": name, "max_abs_err": err,
              "bit_equal": equal, "planted_faults_bit_equal": fault_equal})
        if not equal:
            raise AssertionError(f"{name}: the kernel's q or pools differ "
                                 f"from the plain version's (max abs {err})")
        if any(fault_equal.values()):
            raise AssertionError(f"{name} check passed a planted fault: "
                                 f"{fault_equal}")
        dst = (_clone_pool(kp), _clone_pool(vp))
        k_rot = apply_rope(k, positions, inv_freq)
        library = _library_write(*dst, pids, offs, k_rot, v, li)
        args = (q, k, v, positions, inv_freq, *dst, li, pids, offs)
        ms = time_ms(lambda: rope_kv_write(*args))
        plain_ms = time_ms(lambda: rope_kv_write_plain(*args))
        unfused_ms = time_ms(lambda: unfused_path(*dst))
        lib_ms = time_ms(library)
        dev_ms = device_ms(lambda: rope_kv_write(*args))
        unfused_dev_ms = device_ms(lambda: unfused_path(*dst))
        lib_dev_ms = device_ms(library)
        # bytes: q read and written, the live K and V rows read and
        # written, positions / ids / offsets and the frequency table read
        nbytes = (2 * n * hq * d * 2 + _write_bytes(1, live, hkv, d,
                                                    quantized)
                  + 12 * n + 4 * d // 2)
        bound_ms, bound_by = bound(0.0, nbytes)
        row = {**fields, "wrapper": "rope_kv_write" + form,
               "route": "cuda", "source": "gofr_tpu_torch/csrc/kv_write.cu",
               "replaces": "gofr_tpu/ops/paged_kv.py:124",
               "replaces_note": "apply_rope (gofr_tpu/ops/rope.py:37) on q "
                                "and k and pool_write of K and V, fused by "
                                "XLA into the jitted step at "
                                + ("gofr_tpu/models/llama.py:518-521"
                                   if verify else
                                   "gofr_tpu/models/llama.py:336-339")
                                + "; not a pallas_call",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms,
               "library_note": "no single library call; nearest path: "
                               "index_copy_ of the rotated in-range K and V "
                               "rows (RoPE, selection" + (", quantize"
                                                         if quantized else "")
                               + " beforehand, untimed)",
               "unfused_path_ms": unfused_ms,
               "unfused_path_device_ms": unfused_dev_ms,
               "unfused_path_note": "apply_rope on q and k (13 launches "
                                    "each) + the per-layer kv_write "
                                    "kernel: the steps' write before the "
                                    "fused entry"}
        shape_note = (f"verify: 8 slots x 16 nodes, RoPE at history + depth, "
                      f"rows at history + i, {live} of {n} rows in range, "
                      f"Llama-3.2 rope_scaling" if verify else
                      f"decode: N={n} rows ({live} in range), positions "
                      f"0-2047")
        emit({"phase": "kernel", "shape": f"{shape_note}, Hq={hq} Hkv={hkv} "
              f"hd={d} L={n_layers} Np={n_pages} pg={pg}, layer {li}, "
              + ("int8 {q, s}" if quantized else "bf16"),
              "kernel_ms": ms, **row})
        rows.append(row)
    return rows


def kernel_kv_write_prefill(dev, gen, tp2: bool = False) -> list:
    """The slab entry of the KV write kernel at the group prefill's
    shape, through the wrapper the engine calls there
    (``scatter_chunk_kv``: one launch for every layer, K and V together):
    serve_preempt's first group, 6 prompts of 301 tokens in the 512-row
    bucket at P = 8, so 2 dummy rows of length 1 on all-OOB tables; each
    prompt's table holds its 5 pages (prompt + 1 rows) and OOB past them.
    Slabs [16, 8, 512, 8, 64] bf16 into the serve pool (16 layers, Hkv 8,
    256 pages of 64 rows), one row per pool form. The kernel's pools must
    equal ``scatter_chunk_kv_plain``'s bit for bit (int8 codes and scales
    too); planted fault: the kernel's rows written one offset late, which
    must fail the same check. ``library_ms``: the nearest library path,
    ``index_copy_`` of every layer's in-range rows into each pool leaf
    (selection and quantize beforehand, untimed). ``tp2``: the bf16 form
    at one rank of ``serve_tp`` (Llama-3-70B at 8 layers, tp = 2: Hkv 4,
    head_dim 128), launched by its ranks."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import (_chunk_coords, quantize_pool,
                                             scatter_chunk_kv,
                                             scatter_chunk_kv_plain)
    n_layers, hkv, d, n_pages, pg = ((TP_LAYERS, 4, 128, 256, 64) if tp2
                                     else (16, 8, 64, 256, 64))
    p, bucket, n_prompt, n_real = 8, 512, 301, 6
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    per = -(-(n_prompt + 1) // pg)
    pages = torch.randperm(n_pages, generator=gen, device=dev)
    tables = torch.full((p, 32), n_pages, dtype=torch.int32, device=dev)
    for r in range(n_real):
        tables[r, :per] = pages[r * per:(r + 1) * per]
    lens = torch.tensor([n_prompt] * n_real + [1] * (p - n_real),
                        dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(lens)
    slab = (n_layers, p, bucket, hkv, d)
    k_slab = torch.randn(slab, generator=gen, device=dev).bfloat16()
    v_slab = torch.randn(slab, generator=gen, device=dev).bfloat16()
    live = n_real * n_prompt
    pids, offs = _chunk_coords(k_pool, tables, zeros, lens, bucket)

    rows = []
    for quantized in (False,) if tp2 else (False, True):
        kp, vp = ((quantize_pool(k_pool), quantize_pool(v_pool)) if quantized
                  else (k_pool, v_pool))
        wrapper = "scatter_chunk_kv" + ("_int8" if quantized else "")
        name = "kv_write_prefill" + ("_int8" if quantized else "") \
            + ("_tp2" if tp2 else "")
        args = (tables, k_slab, v_slab)
        want = scatter_chunk_kv_plain(_clone_pool(kp), _clone_pool(vp), *args,
                                      zeros, lens)
        got = scatter_chunk_kv(_clone_pool(kp), _clone_pool(vp), *args, zeros,
                               lens)
        fault = scatter_chunk_kv(_clone_pool(kp), _clone_pool(vp), *args,
                                 zeros + 1, lens)
        lib = (_clone_pool(kp), _clone_pool(vp))
        _library_write(*lib, pids, offs, k_slab, v_slab)()
        torch.cuda.synchronize()
        err, equal = _pools_diff(got, want)
        fault_err, fault_equal = _pools_diff(fault, want)
        emit({"phase": "kernel_check", "name": name, "max_abs_err": err,
              "bit_equal": equal, "planted_fault": "rows_one_offset_late",
              "planted_fault_max_abs_err": fault_err,
              "planted_fault_bit_equal": fault_equal,
              "library_path_bit_equal": _pools_diff(lib, want)[1]})
        if not equal:
            raise AssertionError(f"{name}: kernel pools differ from the "
                                 f"plain version's (max abs {err})")
        if fault_equal:
            raise AssertionError(f"{name} check passed a planted fault "
                                 f"(rows_one_offset_late)")
        del got, fault, want, lib
        dst = (_clone_pool(kp), _clone_pool(vp))
        library = _library_write(*dst, pids, offs, k_slab, v_slab)
        ms = time_ms(lambda: scatter_chunk_kv(*dst, *args, zeros, lens))
        plain_ms = time_ms(lambda: scatter_chunk_kv_plain(*dst, *args, zeros,
                                                          lens))
        lib_ms = time_ms(library)
        dev_ms = device_ms(lambda: scatter_chunk_kv(*dst, *args, zeros,
                                                    lens))
        kernel_dev_ms = device_ms(lambda: scatter_chunk_kv(*dst, *args,
                                                           zeros, lens),
                                  only="kv_write_slab")
        lib_dev_ms = device_ms(library)
        # the live rows of every layer, and the ids read once
        bound_ms, bound_by = bound(0.0, _write_bytes(n_layers, live, hkv, d,
                                                     quantized)
                                   + 8 * p * bucket)
        row = {"name": name, "wrapper": wrapper, "route": "cuda",
               "source": "gofr_tpu_torch/csrc/kv_write.cu",
               "replaces": "gofr_tpu/ops/paged_kv.py:191",
               **({"launches_from": "serve_tp"} if tp2 else {}),
               "replaces_note": "scatter_chunk: XLA's scatter (.at[].set, "
                                "mode='drop', quantize_rows for int8), "
                                "not a pallas_call",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "kernel_device_ms": kernel_dev_ms,
               "device_ms_note": "device_ms: the call's kernels, the page "
                                 "ids and offsets (_chunk_coords) "
                                 "included; kernel_device_ms: the slab "
                                 "kernel alone",
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms,
               "library_note": "no single library call; nearest path: "
                               "index_copy_ of every layer's in-range K "
                               "and V rows into each pool leaf (selection"
                               + (", quantize" if quantized else "")
                               + " beforehand, untimed)"}
        emit({"phase": "kernel", "shape": f"scatter_chunk_kv, 1 launch for "
              f"all {n_layers} layers: slab [{n_layers}, {p}, {bucket}, "
              f"{hkv}, {d}], {n_real} x {n_prompt} rows in range, "
              f"{p - n_real} dummy rows on all-OOB tables, Np={n_pages} "
              f"pg={pg}, " + ("int8 {q, s}" if quantized else "bf16"),
              "kernel_ms": ms, **row})
        rows.append(row)
        del dst, library
    del k_slab, v_slab, k_pool, v_pool
    torch.cuda.empty_cache()
    return rows


def kernel_kv_write_view(dev, gen) -> list:
    """The slab entry of the KV write kernel at head_dim 128, at the
    dense view's write-back in ``serve_moe`` (``scatter_decode_kv``, one
    launch for every layer, K and V together): the T = 8 rows a decode
    dispatch appended to each of 8 slots of a [8 layers, 8 slots, 2048
    rows, Hkv 8, 128] view, into the pool of 256 pages of 64 rows. Slot
    lengths 0 / 1 / 63 / 64 / 900 / 1000 / 2044 (4 of its rows past the
    view, dropped) / 2048 (parked at ``max_seq``: every row dropped), the
    last slot's table all out of range. One row per pool form, bit for
    bit against the plain writer (``scatter_chunk_kv_plain`` of the same
    rows); planted fault: the rows written one offset late.
    ``library_ms``: ``index_copy_`` of the in-range rows, as the other
    write rows."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import (_appended, _chunk_coords,
                                             quantize_pool, scatter_chunk_kv,
                                             scatter_chunk_kv_plain,
                                             scatter_decode_kv)
    n_layers, hkv, d, n_pages, pg, b, steps, width = 8, 8, 128, 256, 64, \
        8, 8, 2048
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    mp = width // pg
    tables = torch.randperm(n_pages, generator=gen, device=dev).to(
        torch.int32).reshape(b, mp)
    tables[-1] = n_pages                          # an idle slot
    lengths = torch.tensor([0, 1, 63, 64, 900, 1000, 2044, 2048],
                           dtype=torch.int32, device=dev)
    view = (n_layers, b, width, hkv, d)
    k_view = torch.randn(view, generator=gen, device=dev).bfloat16()
    v_view = torch.randn(view, generator=gen, device=dev).bfloat16()
    k_rows, keep = _appended(k_view, lengths, steps)
    v_rows, _ = _appended(v_view, lengths, steps)
    pids, offs = _chunk_coords(k_pool, tables, lengths, keep, steps)
    live = int(((pids < n_pages).sum()).item())
    rows = []
    for quantized in (False, True):
        kp, vp = ((quantize_pool(k_pool), quantize_pool(v_pool)) if quantized
                  else (k_pool, v_pool))
        wrapper = "scatter_chunk_kv" + ("_int8" if quantized else "")
        name = "kv_write_view_d128" + ("_int8" if quantized else "")
        want = scatter_chunk_kv_plain(_clone_pool(kp), _clone_pool(vp),
                                      tables, k_rows, v_rows, lengths, keep)
        got = scatter_decode_kv(_clone_pool(kp), _clone_pool(vp), tables,
                                k_view, v_view, lengths, steps)
        fault = scatter_chunk_kv(_clone_pool(kp), _clone_pool(vp), tables,
                                 k_rows, v_rows, lengths + 1, keep)
        torch.cuda.synchronize()
        err, equal = _pools_diff(got, want)
        fault_err, fault_equal = _pools_diff(fault, want)
        emit({"phase": "kernel_check", "name": name, "max_abs_err": err,
              "bit_equal": equal, "planted_fault": "rows_one_offset_late",
              "planted_fault_max_abs_err": fault_err,
              "planted_fault_bit_equal": fault_equal})
        if not equal:
            raise AssertionError(f"{name}: kernel pools differ from the "
                                 f"plain version's (max abs {err})")
        if fault_equal:
            raise AssertionError(f"{name} check passed a planted fault "
                                 f"(rows_one_offset_late)")
        del got, fault, want
        dst = (_clone_pool(kp), _clone_pool(vp))
        library = _library_write(*dst, pids, offs, k_rows, v_rows)
        args = (tables, k_view, v_view, lengths, steps)
        ms = time_ms(lambda: scatter_decode_kv(*dst, *args))
        plain_ms = time_ms(lambda: scatter_chunk_kv_plain(
            *dst, tables, k_rows, v_rows, lengths, keep))
        lib_ms = time_ms(library)
        dev_ms = device_ms(lambda: scatter_decode_kv(*dst, *args))
        kernel_dev_ms = device_ms(lambda: scatter_decode_kv(*dst, *args),
                                  only="kv_write_slab")
        lib_dev_ms = device_ms(library)
        bound_ms, bound_by = bound(0.0, _write_bytes(n_layers, live, hkv, d,
                                                     quantized)
                                   + 8 * b * steps)
        row = {"name": name, "wrapper": wrapper, "route": "cuda",
               "source": "gofr_tpu_torch/csrc/kv_write.cu",
               "replaces": "gofr_tpu/ops/paged_kv.py:216",
               "replaces_note": "scatter_decode: XLA's scatter (.at[].set, "
                                "mode='drop', quantize_rows for int8), "
                                "not a pallas_call",
               "launches_from": "serve_moe",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "kernel_device_ms": kernel_dev_ms,
               "device_ms_note": "device_ms: the call's kernels, the "
                                 "appended rows' gather and the page ids "
                                 "included; kernel_device_ms: the slab "
                                 "kernel alone",
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms,
               "library_note": "no single library call; nearest path: "
                               "index_copy_ of every layer's in-range K "
                               "and V rows into each pool leaf (selection"
                               + (", quantize" if quantized else "")
                               + " beforehand, untimed)"}
        emit({"phase": "kernel", "shape": f"scatter_decode_kv, 1 launch for "
              f"all {n_layers} layers: {b} slots x {steps} rows of a "
              f"[{n_layers}, {b}, {width}, {hkv}, {d}] view, {live} rows in "
              f"range, Np={n_pages} pg={pg}, "
              + ("int8 {q, s}" if quantized else "bf16"),
              "kernel_ms": ms, **row})
        rows.append(row)
        del dst, library
    del k_view, v_view, k_pool, v_pool
    torch.cuda.empty_cache()
    return rows


# ------------------------------------- every head dim and float type
#: float32 outside the tensor cores (NVIDIA data sheet, H100 SXM, 700 W):
#: the bound of a float32 row's operations
PEAK_F32_FLOPS = 67e12
#: (head dim, type, Hq, Hkv, pool layers, the phase whose run gives the
#: rows' launches, tree rows too): OpenLLaMA-3B v2's heads in float16;
#: JAX's demo model (``LlamaConfig.tiny()``) in float32; bf16 at head dim
#: 256 and float16 at Llama-3.2-1B's 64, each served by a small model in
#: ``serve_shapes``
SHAPE_CASES = (
    (100, "float16", 32, 32, 26, "serve_openllama", True),
    (16, "float32", 4, 2, 2, "serve_shapes_tiny", False),
    (256, "bfloat16", 8, 2, 2, "serve_shapes_d256", False),
    (64, "float16", 32, 8, 2, "serve_shapes_d64", False),
)
#: GQA groups above the 16 heads a block holds (the kernels cut them into
#: sub-groups of one KV head): group 32 (Hq 64 / Hkv 2) on the wgmma and
#: split-KV routes, group 48 (Hq 48 / Hkv 1) on the float32 and split-KV
#: routes; no served model has them, so their rows launch nothing on the
#: main path
WIDE_GROUP_CASES = (
    (64, "bfloat16", 64, 2, 2, None, True),
    (16, "float32", 48, 1, 2, None, True),
)
#: the file of each attention route (``_build.attention_route``); the
#: wgmma route's is the kernel's own source
ROUTE_SOURCES = {"split_kv": "gofr_tpu_torch/csrc/paged_decode.cu",
                 "simt": "gofr_tpu_torch/csrc/attn_simt.cuh",
                 "wgmma": {"flash": "gofr_tpu_torch/csrc/flash_attention.cu",
                           "chunk": "gofr_tpu_torch/csrc/paged_chunk.cu",
                           "tree": "gofr_tpu_torch/csrc/paged_chunk.cu"}}


def _route(kernel: str, dtype, d: int) -> dict:
    """The route an attention call takes and its source file."""
    from gofr_tpu_torch.ops._build import attention_route
    route = attention_route(kernel, dtype, d)
    source = ROUTE_SOURCES[route]
    return {"kernel_route": route,
            "source": source[kernel] if isinstance(source, dict) else source}


def _tols(dtype, route: str) -> dict:
    """The per-element limit of a row against its plain version, |out -
    ref| <= atol + rtol |ref| + p_round · (the attention average of |V|):
    a float32 output differs by summation order only (ATOL_F32, RTOL_F32);
    a 16-bit output is rounded on both sides (ATOL, RTOL). The wgmma
    route rounds each softmax weight p to the 16-bit type before P·V
    while l sums the float32 weights, as JAX's kernel rounds P to its
    input type: 2^-8 relative in bf16, 2^-11 in float16, which moves the
    output by at most that share of the attention average of |V|. The
    split-KV decode and the float32 kernel keep P in float32: no
    P-rounding term."""
    import torch
    if dtype == torch.float32:
        return {"atol": ATOL_F32, "rtol": RTOL_F32, "p_round": 0.0}
    p_round = 0.0 if route != "wgmma" else \
        P_ROUND if dtype == torch.bfloat16 else 2.0 ** -11
    return {"atol": ATOL, "rtol": RTOL, "p_round": p_round}


def _shape_row(fields: dict, shape: str, dtype, check_out: dict, call,
               plain, library, flops: float, nbytes: float,
               library_note: str | None = None) -> dict:
    """Time a new-shape row (the kernel's call, its plain version, the
    library call; device times of the kernel and the library call),
    bound it (operations over the peak of the inputs' type: the tensor
    cores' for 16-bit types, float32's otherwise), print its line."""
    import torch
    ms, plain_ms = time_ms(call), time_ms(plain)
    dev_ms = device_ms(call)
    lib_ms = time_ms(library) if library is not None else None
    lib_dev_ms = device_ms(library) if library is not None else None
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    row = {**fields, "route": "cuda", "max_abs_err": check_out["err"],
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms, "library_device_ms": lib_dev_ms}
    if library_note:
        row["library_note"] = library_note
    emit({"phase": "kernel", "shape": shape, "kernel_ms": ms, **row})
    return row


def _attn_check(name: str, out, ref, faults: dict, dtype, route: str,
                abs_v_ref=None) -> dict:
    """The kernel within its limit of the plain version, and every
    planted fault outside it; prints the check line. ``abs_v_ref``: the
    plain version over |V| (the attention average of |V|), which the
    P-rounding term of ``_tols`` scales."""
    tol = _tols(dtype, route)
    extra = tol["p_round"] * abs_v_ref.float() if tol["p_round"] else 0.0
    limits = {"atol": tol["atol"], "rtol": tol["rtol"], "extra": extra}
    err, ratios = check(out, ref, **limits)
    fault_ratios = {k: check(v, ref, **limits)[1] for k, v in faults.items()}
    emit({"phase": "kernel_check", "name": name, "max_abs_err": err, **tol,
          "worst_ratio_per_row": ratios,
          **{f"planted_fault_{k}_worst_ratio": max(v)
             for k, v in fault_ratios.items()}})
    if max(ratios) > 1.0:
        raise AssertionError(f"{name} kernel vs plain: worst err/limit "
                             f"{max(ratios)} > 1")
    passed = [k for k, v in fault_ratios.items() if max(v) <= 1.0]
    if passed:
        raise AssertionError(f"{name} check passed planted faults {passed}")
    return {"err": err}


def _sdpa(q4, k4, v4, group, mask):
    """The library yardstick: SDPA on [B, S, H, D] tensors with GQA
    expanded and a boolean mask, all laid out outside the timed call."""
    import torch.nn.functional as F
    qt = q4.transpose(1, 2).contiguous()
    kt = k4.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v4.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def kernel_shapes(dev, d: int, dtype_name: str, hq: int, hkv: int,
                  n_layers: int, launches_from: str | None, tree: bool,
                  writes: bool = True) -> list:
    """The four kernels at head dim ``d`` in ``dtype_name``, at the
    serving shapes of the model whose heads they are (Hq, Hkv), each
    against its plain version with a planted fault: flash (P 4, S 512,
    kv_lengths 1 / 200 / 511 / 512; fault: every length one short);
    paged decode over both pool forms (B 8, lengths 0-1500 on 64-row
    pages; fault: each slot's partial last page dropped, and for int8 the
    V scales shifted one row); paged chunk over both forms (a 1024-row
    chunk, the second chunk of an 1801-token walk, a 6-row prefix-hit
    suffix, an empty slot; fault: a history page swapped); with ``tree``
    the tree kernel over both forms (the smoke's 8 trees; fault: causal
    masks in place of the trees'); and the fused RoPE + K/V write at a
    decode step's 8 rows into a pool of ``n_layers`` layers, both forms,
    bit for bit (faults: positions one late, the rotate-half sign
    flipped); ``writes=False`` leaves the write out. Each attention row
    runs its route (``_route``) and is held to ``_tols``. Rows are named
    ``<kernel>_d<d>_<type>`` (``_g<group>`` after it for a group above
    16); their launches come from ``launches_from``, or with None from no
    main-path phase (``main_path`` false, launches 0)."""
    import torch
    from gofr_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_plain)
    from gofr_tpu_torch.ops.paged_attention import (
        paged_chunk_attention, paged_chunk_attention_plain,
        paged_decode_attention, paged_decode_attention_plain,
        paged_tree_attention, paged_tree_attention_plain)
    from gofr_tpu_torch.ops.paged_kv import (quantize_pool, rope_kv_write,
                                             rope_kv_write_plain, slot_view)
    from gofr_tpu_torch.ops.rope import rope_frequencies
    dtype = getattr(torch, dtype_name)
    es = torch.finfo(dtype).bits // 8
    gen = torch.Generator(device=dev).manual_seed(d + hq)
    group = hq // hkv
    tag = f"_d{d}_{dtype_name}" + (f"_g{group}" if group > 16 else "")
    shape_tag = f"Hq={hq} Hkv={hkv} hd={d} {dtype_name}"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def fields(kernel, form, source, replaces):
        row = {"name": kernel + form + tag, "wrapper": kernel + form,
               "launches_from": launches_from or "none", "source": source,
               "replaces": replaces}
        if launches_from is None:
            row["main_path"] = False
        return row

    def kv_bytes(rows, quantized):
        return 2 * rows * hkv * ((d + 4) if quantized else es * d)

    rows = []
    # flash
    p, s, lens_l = 4, 512, [1, 200, 511, 512]
    q, k, v = randn(p, s, hq, d), randn(p, s, hkv, d), randn(p, s, hkv, d)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    name = "flash_attention" + tag
    route = _route("flash", dtype, d)
    out = flash_attention(q, k, v, kv_lengths=lens)
    ref = flash_attention_plain(q, k, v, kv_lengths=lens)
    checked = _attn_check(name, out, ref, {"kv_len_short": flash_attention(
        q, k, v, kv_lengths=(lens - 1).clamp(min=1))}, dtype,
        route["kernel_route"],
        flash_attention_plain(q, k, v.abs(), kv_lengths=lens))
    r = torch.arange(s, device=dev)
    mask = ((r[None, :] <= r[:, None])[None]
            & (r[None, None, :] < lens[:, None, None]))[:, None]
    visible = sum(min(i + 1, n) for n in lens_l for i in range(s))
    rows.append(_shape_row(
        {**fields("flash_attention", "", route["source"],
                  "gofr_tpu/ops/flash_attention.py:33"),
         "kernel_route": route["kernel_route"]},
        f"P={p} S={s} {shape_tag}, kv_lengths 1/200/511/512", dtype, checked,
        lambda: flash_attention(q, k, v, kv_lengths=lens),
        lambda: flash_attention_plain(q, k, v, kv_lengths=lens),
        _sdpa(q, k, v, group, mask), 4.0 * d * hq * visible,
        2 * p * s * hq * d * es + kv_bytes(sum(lens_l), False) + 4 * p))

    # the paged pools: 256 pages of 64 rows, random distinct pages a slot
    pg, n_pages = 64, 256
    kp, vp = randn(hkv, n_pages, pg, d), randn(hkv, n_pages, pg, d)
    forms = (("", kp, vp), ("_int8", quantize_pool(kp), quantize_pool(vp)))

    def tables_for(need_rows, mp, seed):
        t = torch.full((len(need_rows), mp), n_pages, dtype=torch.int32)
        perm = torch.randperm(n_pages,
                              generator=torch.Generator().manual_seed(seed))
        used = 0
        for i, n in enumerate(need_rows):
            need = -(-n // pg)
            t[i, :need] = perm[used:used + need].to(torch.int32)
            used += need
        return t.to(dev), perm, used

    def view(pool, tables):
        return slot_view(pool, tables).to(dtype)

    # decode
    lens_l = [0, 1, 63, 64, 65, 1500, 300, 1000]
    b = len(lens_l)
    tables, _, _ = tables_for(lens_l, -(-max(lens_l) // pg), 2)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    qd = randn(b, hq, d)
    cut = torch.where(lens > pg, lens - lens % pg, lens)
    mp = tables.shape[1]
    route = _route("decode", dtype, d)
    for form, kpool, vpool in forms:
        args = (qd, kpool, vpool, tables, lens)
        faults = {"tail_page": paged_decode_attention(qd, kpool, vpool,
                                                      tables, cut)}
        if form:
            faults["v_scales_shifted"] = paged_decode_attention(
                qd, kpool, _shift_v_scales(vpool), tables, lens)
        name = "paged_decode_attention" + form + tag
        out = paged_decode_attention(*args)
        checked = _attn_check(name, out, paged_decode_attention_plain(*args),
                              faults, dtype, route["kernel_route"])
        if any(out[i].abs().max().item() != 0.0
               for i, n in enumerate(lens_l) if n == 0):
            raise AssertionError(f"{name}: a zero-length slot is not zero")
        dmask = (torch.arange(mp * pg, device=dev)[None, :]
                 < lens[:, None])[:, None, None, :]
        rows.append(_shape_row(
            {**fields("paged_decode_attention", form, route["source"],
                      "gofr_tpu/ops/paged_attention.py:"
                      + ("138" if form else "134")),
             "kernel_route": route["kernel_route"]},
            f"B={b} {shape_tag} pg={pg} Np={n_pages}, lengths "
            f"0/1/63/64/65/1500/300/1000, " + ("int8 {q, s}" if form
                                               else "plain pool"),
            dtype, checked, lambda args=args: paged_decode_attention(*args),
            lambda args=args: paged_decode_attention_plain(*args),
            _sdpa(qd[:, None], view(kpool, tables), view(vpool, tables),
                  group, dmask),
            sum(4.0 * n * hq * d for n in lens_l),
            sum(kv_bytes(n, bool(form)) for n in lens_l) + 2 * b * hq * d * es
            + sum(-(-n // pg) for n in lens_l) * 4 + 4 * b,
            "SDPA on the gathered view (an int8 pool dequantized to the "
            "activation type beforehand, untimed)"))

    # chunk
    sq, hists, clens = 1024, [0, 1024, 896, 0], [1024, 777, 6, 0]
    b = len(hists)
    tables, perm, used = tables_for([h + c for h, c in zip(hists, clens)],
                                    32, 3)
    bad = tables.clone()
    for i, h in enumerate(hists):
        if h:
            bad[i, (h - 1) // pg] = int(perm[used + i])
    hist = torch.tensor(hists, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    qc = randn(b, sq, hq, d)
    mp = tables.shape[1]
    pos = torch.arange(mp * pg, device=dev)[None, None, :]
    q_pos = (hist[:, None] + torch.arange(sq, device=dev)[None, :])[:, :, None]
    cmask = ((pos <= q_pos) & (pos < (hist + clen)[:, None, None]))[:, None]
    visible = sum(min(h + i + 1, mp * pg) for h, c in zip(hists, clens)
                  for i in range(c))
    kv_rows = [h + c for h, c in zip(hists, clens)]
    route = _route("chunk", dtype, d)
    for form, kpool, vpool in forms:
        args = (qc, kpool, vpool, tables, hist, clen)
        faults = {"history_page": paged_chunk_attention(qc, kpool, vpool,
                                                        bad, hist, clen)}
        name = "paged_chunk_attention" + form + tag
        out = paged_chunk_attention(*args)
        checked = _attn_check(
            name, out, paged_chunk_attention_plain(*args), faults, dtype,
            route["kernel_route"], paged_chunk_attention_plain(
                qc, kpool, _abs_pool(vpool), tables, hist, clen))
        rows.append(_shape_row(
            {**fields("paged_chunk_attention", form, route["source"],
                      "gofr_tpu/ops/paged_attention.py:"
                      + ("362" if form else "357")),
             "kernel_route": route["kernel_route"]},
            f"B={b} Sq={sq} {shape_tag} pg={pg} Np={n_pages} Mp={mp}, "
            f"(history, chunk) (0, 1024) (1024, 777) (896, 6) (0, 0), "
            + ("int8 {q, s}" if form else "plain pool"), dtype, checked,
            lambda args=args: paged_chunk_attention(*args),
            lambda args=args: paged_chunk_attention_plain(*args),
            _sdpa(qc, view(kpool, tables), view(vpool, tables), group,
                  cmask),
            4.0 * d * hq * visible,
            sum(clens) * hq * d * es + b * sq * hq * d * es
            + sum(kv_bytes(n, bool(form)) for n in kv_rows)
            + sum(-(-n // pg) for n in kv_rows) * 4 + 8 * b,
            "SDPA on the gathered view (an int8 pool dequantized to the "
            "activation type beforehand, untimed)"))

    # tree
    if tree:
        slots = _tree_slots()
        width = 16
        b = len(slots)
        hists = [h for h, _, _ in slots]
        clens = [c for _, _, c in slots]
        masks = torch.zeros(b, width, dtype=torch.int32)
        for i, (_, t, _) in enumerate(slots):
            if t is not None:
                masks[i, :t.n_nodes] = torch.tensor(t.masks).to(torch.int32)
        masks = masks.to(dev)
        causal = torch.cumsum(1 << torch.arange(width, device=dev), 0)
        causal = causal.to(torch.int32)[None].expand(b, width).contiguous()
        tables, _, _ = tables_for([h + width for h in hists], 32, 4)
        hist = torch.tensor(hists, dtype=torch.int32, device=dev)
        clen = torch.tensor(clens, dtype=torch.int32, device=dev)
        qt = randn(b, width, hq, d)
        mp = tables.shape[1]
        pos = torch.arange(mp * pg, device=dev)[None, None, :]
        rel = pos - hist[:, None, None]
        bit = (masks[:, :, None].long() >> rel.clamp(0, 31)) & 1
        tmask = ((rel < 0) | ((rel < clen[:, None, None]) & (bit == 1)))
        tmask = (tmask & (torch.arange(width, device=dev)[None, :, None]
                          < clen[:, None, None]))[:, None]
        visible = int(tmask.sum())
        kv_rows = [h + c for h, c in zip(hists, clens)]
        route = _route("tree", dtype, d)
        for form, kpool, vpool in forms:
            args = (qt, kpool, vpool, tables, hist, clen, masks)
            faults = {"causal_masks": paged_tree_attention(
                qt, kpool, vpool, tables, hist, clen, causal)}
            name = "paged_tree_attention" + form + tag
            out = paged_tree_attention(*args)
            checked = _attn_check(
                name, out, paged_tree_attention_plain(*args), faults, dtype,
                route["kernel_route"], paged_tree_attention_plain(
                    qt, kpool, _abs_pool(vpool), tables, hist, clen, masks))
            rows.append(_shape_row(
                # the slice's serving path runs no speculation
                {**fields("paged_tree_attention", form, route["source"],
                          "gofr_tpu/ops/paged_attention.py:"
                          + ("619" if form else "614")),
                 "kernel_route": route["kernel_route"], "main_path": False},
                f"B={b} W={width} {shape_tag} pg={pg} Np={n_pages} Mp={mp}, "
                f"histories 0/1/63/64/65/1500/300/1000, "
                + ("int8 {q, s}" if form else "plain pool"), dtype, checked,
                lambda args=args: paged_tree_attention(*args),
                lambda args=args: paged_tree_attention_plain(*args),
                _sdpa(qt, view(kpool, tables), view(vpool, tables), group,
                      tmask),
                4.0 * d * hq * visible,
                sum(clens) * hq * d * es * 2
                + sum(kv_bytes(n, bool(form)) for n in kv_rows)
                + sum(-(-n // pg) for n in kv_rows) * 4 + 8 * b
                + 4 * b * width,
                "SDPA on the gathered view with the trees' visibility as a "
                "boolean mask (an int8 pool dequantized beforehand)"))

    if not writes:
        return rows
    # the fused RoPE + K/V write at a decode step's 8 rows
    li = n_layers // 2
    wshape = (n_layers, hkv, n_pages, pg, d)
    k_pool, v_pool = randn(*wshape), randn(*wshape)
    positions = torch.tensor([0, 2047, 1500, 63, 64, 901, 7, 1024],
                             dtype=torch.int32, device=dev)
    pids = torch.tensor([17, 3, n_pages, 200, -1, 64, n_pages, 9],
                        dtype=torch.int32, device=dev)
    offs = positions % pg
    inv_freq = rope_frequencies(d, 10000.0, device=dev)
    n = pids.numel()
    live = int(((pids >= 0) & (pids < n_pages)).sum())
    qw, kw, vw = randn(n, hq, d), randn(n, hkv, d), randn(n, hkv, d)
    for form in ("", "_int8"):
        kpool, vpool = ((quantize_pool(k_pool), quantize_pool(v_pool))
                        if form else (k_pool, v_pool))

        def run(fn, pos=positions, inv=inv_freq, kpool=kpool, vpool=vpool):
            pools = (_clone_pool(kpool), _clone_pool(vpool))
            q_rot = fn(qw, kw, vw, pos, inv, *pools, li, pids, offs)
            torch.cuda.synchronize()
            return q_rot, pools

        name = "rope_kv_write" + form + tag
        want_q, want = run(rope_kv_write_plain)
        got_q, got = run(rope_kv_write)
        err, equal = _pools_diff(got, want)
        err = max(err, (got_q.float() - want_q.float()).abs().max().item())
        equal = equal and torch.equal(got_q, want_q)
        fault_equal = {}
        for fault, (pos, inv) in {
                "positions_one_late": (positions + 1, inv_freq),
                "rotate_half_sign_flipped": (positions, -inv_freq)}.items():
            fq, fp = run(rope_kv_write, pos, inv)
            fault_equal[fault] = torch.equal(fq, want_q) and \
                _pools_diff(fp, want)[1]
        emit({"phase": "kernel_check", "name": name, "max_abs_err": err,
              "bit_equal": equal, "planted_faults_bit_equal": fault_equal})
        if not equal or any(fault_equal.values()):
            raise AssertionError(f"{name}: bit equal {equal}, planted faults "
                                 f"that passed {fault_equal}")
        dst = (_clone_pool(kpool), _clone_pool(vpool))
        args = (qw, kw, vw, positions, inv_freq, *dst, li, pids, offs)
        from gofr_tpu_torch.ops.rope import apply_rope
        library = _library_write(*dst, pids, offs,
                                 apply_rope(kw, positions, inv_freq), vw, li)
        row_bytes = hkv * ((d + 4) if form else es * d)
        rows.append(_shape_row(
            {**fields("rope_kv_write", form, "gofr_tpu_torch/csrc/kv_write.cu",
                      "gofr_tpu/ops/paged_kv.py:124"),
             "replaces_note": "apply_rope (gofr_tpu/ops/rope.py:37) on q and "
                              "k and pool_write of K and V, fused by XLA "
                              "into the jitted step at "
                              "gofr_tpu/models/llama.py:336-339; not a "
                              "pallas_call"},
            f"decode: N={n} rows ({live} in range), positions 0-2047, "
            f"{shape_tag} L={n_layers} Np={n_pages} pg={pg}, layer {li}, "
            + ("int8 {q, s}" if form else "plain pool"), dtype,
            {"err": err}, lambda args=args: rope_kv_write(*args),
            lambda args=args: rope_kv_write_plain(*args), library, 0.0,
            2 * n * hq * d * es + 2 * live * (hkv * d * es + row_bytes)
            + 12 * n + 4 * d // 2,
            "no single library call; nearest path: index_copy_ of the "
            "rotated in-range K and V rows (RoPE, selection"
            + (", quantize" if form else "") + " beforehand, untimed)"))
    return rows


#: llama3_1b's quantized products, every matrix stored [N, K]: (name,
#: K, N, head); the tied head reads the [V, D] embedding codes
WQ_PRODUCTS = (("wq", 2048, 2048, False), ("wk", 2048, 512, False),
               ("w1", 2048, 8192, False), ("w2", 8192, 2048, False),
               ("head", 2048, 128256, True))
#: rows of a product: one request, the decode step (max_batch) and the
#: tree verify (8 rows x the 16-node width bucket)
WQ_ROWS = (1, 8, 128)


def _wq_weight(dev, gen, k, n, head, form):
    """A random llama3_1b-like matrix quantized on the card, [N, K]
    reduced over K (per-output-channel scales), as ``quantize_llama_*``
    lays out every quantized matrix: N(0, 1/K) for the layer matrices,
    N(0, 0.02^2) for the embedding read as the head."""
    import torch
    from gofr_tpu_torch.ops.quant import quantize_int4, quantize_int8
    qfn = quantize_int8 if form == "int8" else quantize_int4
    std = 0.02 if head else k ** -0.5
    w = (torch.randn(n, k, generator=gen, device=dev) * std).bfloat16()
    return qfn(w, axis=1)


def _wq_fault(w, form):
    """Planted faults: the scales shifted by one channel; the codes
    k-permuted (the two 8-byte halves of every 16-byte piece of a row
    swapped: k 2t and 2t + 8 of an mma step exchanged for int8, k-steps
    exchanged for int4); for a square matrix its codes transposed
    (``[K, N]`` read as ``[N, K]``); for int4 every byte's two nibbles
    swapped (codes read in the wrong order)."""
    import torch
    q = w["q"]
    out = {"scales_shifted_one_channel": {
        "q": q, "s": torch.roll(w["s"].reshape(-1), 1).reshape(
            w["s"].shape).contiguous()},
        "codes_k_permuted": {
            "q": q.reshape(q.shape[0], -1, 2, 8).flip(2).reshape(
                q.shape).contiguous(), "s": w["s"]}}
    if form == "int8" and q.shape[0] == q.shape[1]:
        out["codes_transposed"] = {"q": q.t().contiguous(), "s": w["s"]}
    if form == "int4":
        out["int4_nibbles_swapped"] = {"q": ((q >> 4) | (q << 4)),
                                       "s": w["s"]}
    return out


def kernel_wq_gemm(dev, gen, smi_line: str) -> list:
    """The weight-dequantizing GEMM (``ops/quant.wq_gemm``, both C
    entries) at llama3_1b's shapes, every matrix in the one ``[N, K]``
    layout: wq 2048->2048, wk 2048->512, w1 2048->8192, w2 8192->2048
    (bf16 out) and the tied head 2048->128256 (float32 out), each at
    M = 1, 8 and 128 rows, int8 and int4 codes, x ~ N(0, 1) bf16. Each
    against its plain version (``wq_gemm_plain``: the codes dequantized
    into a scratch, one product, the scale) on the same inputs: the bf16
    outputs within ATOL + 2 RTOL |ref| (they are rounded twice on each
    side, the product, then the product times the scale, and a one-ulp
    difference of the first rounding can become two ulps of the second),
    the float32 head within ATOL_F32 + RTOL_F32 |ref|. Planted faults
    (``_wq_fault``): scales shifted, codes k-permuted, the square wq's
    codes transposed, int4 nibbles swapped, and for the head its output
    rounded to bf16; each must fail the same check. Times: ``ms`` (CUDA
    events, the wrapper included), ``device_ms`` (profiler, L2 cold: the
    weights come from HBM, as each layer's do in a decode step), the
    plain version's ms, the library yardstick — cuBLAS bf16
    (``torch.matmul``, float32 out for the head) on the weights
    dequantized beforehand, untimed — and, for int8,
    ``torch._weight_int8pack_mm`` where the card's torch runs it. Bound:
    the codes, scales, x and y over the HBM rate (and the products over
    the bf16 peak). Then M_MAX: the kernel and the plain route at w1's
    shape over M = 16..2048, and the route each product of the serving
    path takes. Returns the M = 8 rows (the decode step), for the
    kernels line."""
    import torch
    from gofr_tpu_torch.ops.quant import (M_MAX, codes_of, route_of,
                                          wq_gemm, wq_gemm_plain,
                                          wq_groups, wq_splits)
    rows = []
    for form in ("int8", "int4"):
        for name, k, n, head in WQ_PRODUCTS:
            w = _wq_weight(dev, gen, k, n, head, form)
            f32 = torch.float32 if head else None
            # the yardstick's weight, [K, N]
            deq = (codes_of(w).to(torch.bfloat16)
                   * w["s"].to(torch.bfloat16)).t()
            faults = _wq_fault(w, form)
            for m in WQ_ROWS:
                x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
                out = wq_gemm(x, w, out_dtype=f32)
                ref = wq_gemm_plain(x, w, out_dtype=f32)
                torch.cuda.synchronize()
                tol = ({"atol": ATOL_F32, "rtol": RTOL_F32} if head else
                       {"extra": RTOL * ref.float().abs()})
                err, ratios = check(out, ref, **tol)
                again = wq_gemm(x, w, out_dtype=f32)
                fault_ratio = {}
                for fname, bad in faults.items():
                    fout = wq_gemm(x, bad, out_dtype=f32)
                    fault_ratio[fname] = max(check(fout, ref, **tol)[1])
                if head:
                    fault_ratio["head_rounded_to_bf16"] = max(check(
                        out.bfloat16(), ref, **tol)[1])
                tag = f"wq_gemm_{form}_{name}_m{m}"
                emit({"phase": "kernel_check", "name": tag,
                      "max_abs_err": err, "max_ratio": max(ratios),
                      "atol": ATOL_F32 if head else ATOL,
                      "rtol": RTOL_F32 if head else 2 * RTOL,
                      "second_call_bit_equal": bool(torch.equal(out, again)),
                      "planted_fault_max_ratio": fault_ratio})
                if max(ratios) > 1.0:
                    raise AssertionError(f"{tag}: kernel vs plain ratio "
                                         f"{max(ratios)} > 1 (max abs {err})")
                if not torch.equal(out, again):
                    raise AssertionError(f"{tag}: two calls differ")
                passed = [f for f, r in fault_ratio.items() if r <= 1.0]
                if passed:
                    raise AssertionError(f"{tag} check passed a planted "
                                         f"fault: {passed}")
                ms = time_ms(lambda: wq_gemm(x, w, out_dtype=f32))
                dev_ms = device_ms(lambda: wq_gemm(x, w, out_dtype=f32),
                                   cold=True)
                plain_ms = time_ms(lambda: wq_gemm_plain(
                    x, w, out_dtype=f32), iters=10)
                if head:
                    def lib():
                        return torch.mm(x, deq, out_dtype=torch.float32)
                else:
                    def lib():
                        return torch.matmul(x, deq)
                lib_ms = time_ms(lib)
                lib_dev_ms = device_ms(lib, cold=True)
                pack_ms = pack_note = None
                if form == "int8":
                    try:
                        sc = w["s"].reshape(-1).to(torch.bfloat16)
                        torch._weight_int8pack_mm(x, w["q"], sc)
                        torch.cuda.synchronize()
                        pack_ms = time_ms(
                            lambda: torch._weight_int8pack_mm(x, w["q"], sc))
                    except (RuntimeError, NotImplementedError) as exc:
                        pack_note = str(exc).splitlines()[0][:160]
                nbytes = (w["q"].numel() + 4 * n + 2 * m * k
                          + m * n * (4 if head else 2))
                bound_ms, bound_by = bound(2.0 * m * n * k, nbytes)
                row = {"name": f"wq_gemm_{form}_{name}" if m == 8 else tag,
                       "wrapper": "wq_gemm" + ("_int4" if form == "int4"
                                               else ""),
                       "route": "cuda",
                       "source": "gofr_tpu_torch/csrc/wq_gemm.cu",
                       "replaces": "gofr_tpu/ops/quant.py:86",
                       "replaces_note": "qmatmul / qmatmul_t: XLA's matmul "
                                        "with the upcast fused into its "
                                        "operand read, not a pallas_call",
                       "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms,
                       "library_device_ms": lib_dev_ms,
                       "library_note": "cuBLAS bf16 on the weights "
                                       "dequantized beforehand, untimed",
                       "int8pack_ms": pack_ms}
                groups = wq_groups(m, n)
                splits = wq_splits(m, n, k, int4=form == "int4",
                                   groups=groups)
                emit({"phase": "kernel", "card": smi_line,
                      "shape": f"{name} K={k} N={n} M={m} {form} [N, K] "
                               f"codes, G={groups} S={splits}",
                      "int8pack_note": pack_note, **row})
                if m == 8:
                    rows.append(row)
            del w, deq, faults
            torch.cuda.empty_cache()
    # M_MAX: the kernel against the plain route at w1's shape
    sweep = []
    for form in ("int8", "int4"):
        w = _wq_weight(dev, gen, 2048, 8192, False, form)
        for m in (16, 32, 64, 128, 256, 512, 1024, 2048):
            x = torch.randn(m, 2048, generator=gen, device=dev).bfloat16()
            sweep.append({
                "form": form, "m": m,
                "kernel_device_ms": device_ms(lambda: wq_gemm(x, w),
                                              cold=True),
                "plain_device_ms": device_ms(lambda: wq_gemm_plain(x, w),
                                             cold=True)})
        del w
    routes = {f"{what} M={m}": {p[0]: route_of(m, head=p[3])
                                for p in WQ_PRODUCTS}
              for what, m in (("decode step", 8), ("tree verify", 128),
                              ("group prefill 2 x 256", 512),
                              ("group prefill 4 x 512", 2048),
                              ("chunk walk 1 x 1024", 1024))}
    routes["group prefill's head, M = P"] = route_of(8, head=True)
    emit({"phase": "wq_gemm_route", "card": smi_line, "m_max": M_MAX,
          "w1_sweep": sweep, "routes": routes})
    torch.cuda.empty_cache()
    return rows


def phase_moe_tie(dev) -> None:
    """The MoE router's tie order on the card: ``top_k_routing`` of
    router logits that tie must pick the lowest expert indices, as
    ``lax.top_k`` does (a stable descending sort, cut to k). Two cases
    of 4 rows over 8 experts: every logit tied (a zero gate: experts
    [0, 1]) and a tie for second place only (expert 5 first, 2, 3 and 6
    tied: [5, 2]); and ``moe_layer`` under the zero gate must give the
    even mix of experts 0 and 1. Planted fault: the tie broken toward the
    highest index (the sort run on the logits reversed along E), which
    must fail the same check. ``torch.topk``'s own order on the same
    logits is printed (it promises none)."""
    import torch
    from gofr_tpu_torch.ops.moe import moe_layer, top_k_routing
    e, want = 8, {"all": [0, 1], "second": [5, 2]}
    scale = torch.tensor([0.125, 0.125, 0.5, 0.5, 0.125, 1.0, 0.5, 0.125],
                         device=dev)
    logits = {"all": torch.zeros(4, e, device=dev),
              "second": torch.ones(4, 1, device=dev) * scale}

    def flipped(x):
        _, idx = top_k_routing(x.flip(-1), 2)
        return e - 1 - idx

    got = {k: top_k_routing(x, 2)[1].tolist() for k, x in logits.items()}
    fault = {k: flipped(x).tolist() for k, x in logits.items()}
    topk = {k: torch.topk(x, 2).indices.tolist() for k, x in logits.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, f = 16, 32
    x = torch.randn(4, d, generator=gen, device=dev)
    w1, w3 = (torch.randn(e, d, f, generator=gen, device=dev) * 0.1
              for _ in range(2))
    w2 = torch.randn(e, f, d, generator=gen, device=dev) * 0.1
    out, _ = moe_layer(x, torch.zeros(d, e, device=dev), w1, w3, w2)
    mix = sum(0.5 * (torch.nn.functional.silu(x @ w1[i]) * (x @ w3[i]))
              @ w2[i] for i in (0, 1))
    err = (out - mix).abs().max().item()
    ok = {k: got[k] == [want[k]] * 4 for k in want}
    fault_ok = {k: fault[k] == [want[k]] * 4 for k in want}
    emit({"phase": "moe_tie", "picked": got, "want_each_row": want,
          "torch_topk_order": topk, "moe_layer_vs_experts_0_1_abs": err,
          "planted_fault_highest_index_first": fault})
    if not all(ok.values()) or err > 1e-5:
        raise AssertionError(f"moe_tie: the router picked {got} (want "
                             f"{want} in every row), moe_layer vs experts "
                             f"0 and 1: {err}")
    if any(fault_ok.values()):
        raise AssertionError(f"moe_tie check passed a planted fault: {fault}")


def phase_model(dev) -> None:
    """llama3_1b prefill + 3 paged decode steps, kernels vs plain, and
    once more with a planted fault.

    LOGITS_TOL: the paths differ only inside attention, where the
    kernels round P to bf16 and sum in another order; each attention
    output then differs by about one bf16 ulp (~0.4 % relative). Through
    16 residual layers that stays a perturbation of order 1e-2 of the
    final hidden state, and the logits (rms-normed hidden · embeddings
    of std 0.02 over dim 2048, so |logit| ~ 1) move by a few 1e-2.
    The planted fault passes ``lengths - 1`` to the decode kernel (the
    newest row is not attended); its decode steps must differ from the
    plain path by more than LOGITS_TOL, so the limit sits between a
    sound reading and a faulty one.
    """
    from unittest import mock

    import torch
    from gofr_tpu_torch.models import llama as llama_module
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_decode_step_paged,
                                             llama_init, llama_prefill_last,
                                             make_pool)
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention
    from gofr_tpu_torch.ops.paged_kv import (scatter_chunk_kv,
                                             scatter_chunk_kv_plain)

    def short_by_one(q, k_pool, v_pool, tables, lengths):
        return paged_decode_attention(q, k_pool, v_pool, tables, lengths - 1)

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    p, s, pg = 2, 256, 64
    tokens = torch.randint(0, cfg.vocab_size, (p, s), generator=gen,
                           device=dev)
    lens = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    mp = -(-(s + 3) // pg)
    tables = torch.arange(p * mp, dtype=torch.int32,
                          device=dev).reshape(p, mp)
    results: dict = {}
    step_tokens: list = []   # both paths decode the kernel path's picks
    t0 = time.perf_counter()
    for run in ("auto", "plain", "fault"):
        impl = "plain" if run == "plain" else "auto"
        logits, (k, v) = llama_prefill_last(params, tokens, cfg,
                                            kv_lengths=lens,
                                            implementation=impl)
        kp, vp = make_pool(cfg, p * mp, pg, dev)
        zeros = torch.zeros_like(lens)
        (scatter_chunk_kv_plain if impl == "plain" else scatter_chunk_kv)(
            kp, vp, tables, k, v, zeros, lens)
        results[run] = [logits]
        cur = lens.clone()
        for step in range(3):
            if run == "auto":
                step_tokens.append(results["auto"][-1].argmax(-1))
            with mock.patch.object(llama_module, "paged_decode_attention",
                                   short_by_one if run == "fault"
                                   else paged_decode_attention):
                logits, kp, vp = llama_decode_step_paged(
                    params, step_tokens[step], kp, vp, tables, cur, cfg,
                    implementation=impl)
            results[run].append(logits)
            cur = cur + 1
    torch.cuda.synchronize()

    def diffs(run):
        return [(a - b).abs().max().item()
                for a, b in zip(results[run], results["plain"])]

    errs, fault_errs = diffs("auto"), diffs("fault")[1:]
    finite = all(torch.isfinite(t).all().item()
                 for ts in results.values() for t in ts)
    scale = max(t.abs().max().item() for t in results["plain"])
    emit({"phase": "model", "config": "llama3_1b bf16 random seed 0",
          "prefill": "P=2 S=256 kv_lengths 256/100", "decode_steps": 3,
          "max_abs_logits_diff_per_call": errs, "max_abs_logit": scale,
          "tolerance": LOGITS_TOL, "finite": finite,
          "planted_fault_diff_per_decode_step": fault_errs,
          "seconds": time.perf_counter() - t0})
    if not finite or max(errs) > LOGITS_TOL:
        raise AssertionError(f"model kernels vs plain: logits diff {errs} "
                             f"(tolerance {LOGITS_TOL}), finite={finite}")
    if min(fault_errs) <= LOGITS_TOL:
        raise AssertionError(f"model check passed a planted fault: decode "
                             f"logits diff {fault_errs} <= {LOGITS_TOL}")
    del params, results
    torch.cuda.empty_cache()


def phase_model_chunk(dev) -> None:
    """llama3_1b through ``llama_prefill_chunk_paged``, at full width.

    (a) A two-row chunk — a fresh 128-token prompt, and 100 tokens after
    a 640-row history (prefilled through flash and written to the pool)
    — through the kernels and through the plain versions, each on its
    own copy of the pools: logits within LOGITS_TOL (the reasoning of
    ``phase_model`` holds: the paths differ only inside attention, by
    bf16 rounding of P). A planted fault passes ``history - 1`` to the
    chunk kernel, so each row of the history slot loses its own K/V row
    and sees one stale one; its logits must differ by more.
    (b) An 1800-token prompt walked in two chunks (1024 rows, then the
    rest padded to the 1024 bucket, as the engine walks it) against
    ``llama_prefill_last`` over the whole prompt, both through the
    kernels: the chunk kernel against the flash kernel on the same work,
    within LOGITS_TOL.
    """
    from unittest import mock

    import torch
    from gofr_tpu_torch.models import llama as llama_module
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                             llama_prefill_chunk_paged,
                                             llama_prefill_last, make_pool)
    from gofr_tpu_torch.ops.paged_attention import paged_chunk_attention
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk_kv_plain

    def history_short_by_one(q, k_pool, v_pool, tables, history, chunk):
        return paged_chunk_attention(q, k_pool, v_pool, tables,
                                     (history - 1).clamp(min=0), chunk)

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    t0 = time.perf_counter()
    pg, hist_len, s = 64, 640, 128
    mp = -(-(hist_len + s) // pg)
    tables = torch.arange(2 * mp, dtype=torch.int32, device=dev).reshape(2, mp)
    history = torch.randint(0, cfg.vocab_size, (1, hist_len), generator=gen,
                            device=dev)
    _, (k, v) = llama_prefill_last(
        params, history, cfg,
        kv_lengths=torch.tensor([hist_len], dtype=torch.int32, device=dev))
    kp0, vp0 = make_pool(cfg, 2 * mp, pg, dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    full = torch.tensor([hist_len], dtype=torch.int32, device=dev)
    scatter_chunk_kv_plain(kp0, vp0, tables[1:], k, v, zero, full)
    tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                           device=dev)
    offsets = torch.tensor([0, hist_len], dtype=torch.int32, device=dev)
    lens = torch.tensor([s, 100], dtype=torch.int32, device=dev)
    logits = {}
    for run in ("auto", "plain", "fault"):
        with mock.patch.object(llama_module, "paged_chunk_attention",
                               history_short_by_one if run == "fault"
                               else paged_chunk_attention):
            logits[run], _, _ = llama_prefill_chunk_paged(
                params, tokens, kp0.clone(), vp0.clone(), tables, offsets,
                lens, cfg, implementation="plain" if run == "plain"
                else "auto")
    diff = (logits["auto"] - logits["plain"]).abs().amax(1).tolist()
    fault = (logits["fault"] - logits["plain"]).abs().amax(1).tolist()

    n, first = 1800, 1024
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    whole, _ = llama_prefill_last(
        params, prompt, cfg,
        kv_lengths=torch.tensor([n], dtype=torch.int32, device=dev))
    mp_w = -(-n // pg)
    kp, vp = make_pool(cfg, mp_w, pg, dev)
    walk_tables = torch.arange(mp_w, dtype=torch.int32, device=dev)[None]
    for off in (0, first):
        chunk = torch.zeros(1, first, dtype=torch.long, device=dev)
        piece = prompt[:, off:off + first]
        chunk[:, :piece.shape[1]] = piece
        walked, kp, vp = llama_prefill_chunk_paged(
            params, chunk, kp, vp, walk_tables,
            torch.tensor([off], dtype=torch.int32, device=dev),
            torch.tensor([piece.shape[1]], dtype=torch.int32, device=dev), cfg)
    walk_diff = (walked - whole).abs().max().item()
    torch.cuda.synchronize()
    finite = all(torch.isfinite(t).all().item()
                 for t in (*logits.values(), whole, walked))
    emit({"phase": "model_chunk", "config": "llama3_1b bf16 random seed 0",
          "chunk": "rows (offset 0, 128 tokens) and (offset 640, 100 "
          "tokens), pg 64", "max_abs_logits_diff_per_row": diff,
          "planted_fault_diff_per_row": fault,
          "walk": "1800 tokens in chunks of 1024 + 776 vs whole-prompt "
          "flash prefill", "walk_max_abs_logits_diff": walk_diff,
          "tolerance": LOGITS_TOL, "finite": finite,
          "seconds": time.perf_counter() - t0})
    if not finite or max(diff) > LOGITS_TOL or walk_diff > LOGITS_TOL:
        raise AssertionError(f"model chunk path: kernel vs plain {diff}, "
                             f"walk vs whole prompt {walk_diff} (tolerance "
                             f"{LOGITS_TOL}), finite={finite}")
    if fault[1] <= LOGITS_TOL:
        raise AssertionError(f"model chunk check passed a planted fault: "
                             f"history-row logits diff {fault[1]} <= "
                             f"{LOGITS_TOL}")
    del params, logits, kp, vp, kp0, vp0
    torch.cuda.empty_cache()


def phase_model_spec(dev) -> None:
    """llama3_1b speculative verify through ``llama_prefill_chunk_paged``
    in tree mode, at full width.

    A 400-token prompt is prefilled through flash and written to the
    pool; its greedy token t0 is then fed to 6 sequential
    ``llama_decode_step_paged`` steps, step k feeding t_k at position
    400 + k and giving logits D_k, whose argmax is t_(k+1). On a fresh
    copy of the pool a 9-node tree is verified: root t0, a decoy branch
    of 4 wrong tokens (nodes 1-4), and the chain t1..t4 (nodes 5-8), in
    the 16-wide bucket, through the kernels and through the plain
    versions. Checks, each against LOGITS_TOL (``phase_model``'s
    reasoning: the paths differ in attention rounding and GEMM shapes):
    kernel vs plain node logits; root vs D_0 and chain node k vs D_k;
    the resolve accepts the chain at least through every leading depth
    whose decode margin (top-1 minus top-2 of D_(k-1)) exceeds
    2 × LOGITS_TOL, where no rounding can flip the argmax; causal masks
    in place of the tree masks (the chain then sees the decoy) move the
    logits by more than LOGITS_TOL; and after ``pool_move_rows`` compacts
    the accepted path (rows 400 + 5.. moved to 400 + 1..), one decode
    step feeding the next sequential token gives that step's sequential
    logits.
    """
    import torch
    from gofr_tpu_torch.models.llama import (LlamaConfig,
                                             llama_decode_step_paged,
                                             llama_init,
                                             llama_prefill_chunk_paged,
                                             llama_prefill_last, make_pool)
    from gofr_tpu_torch.ops.paged_kv import (pool_move_rows,
                                             scatter_chunk_kv_plain)
    from gofr_tpu_torch.serving.engine import path_moves, resolve_tree
    from gofr_tpu_torch.serving.spec import build_draft_tree

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    t0 = time.perf_counter()
    n, pg, w = 400, 64, 16
    mp = -(-(n + w) // pg)
    tables = torch.arange(mp, dtype=torch.int32, device=dev)[None]
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    first, (k, v) = llama_prefill_last(
        params, prompt, cfg,
        kv_lengths=torch.tensor([n], dtype=torch.int32, device=dev))
    kp, vp = make_pool(cfg, mp, pg, dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    full = torch.tensor([n], dtype=torch.int32, device=dev)
    scatter_chunk_kv_plain(kp, vp, tables, k, v, zero, full)
    base_k, base_v = kp.clone(), vp.clone()
    toks = [int(first.argmax())]
    dec, margins = [], []
    for step in range(6):
        logits, kp, vp = llama_decode_step_paged(
            params, torch.tensor([toks[-1]], device=dev), kp, vp, tables,
            torch.tensor([n + step], dtype=torch.int32, device=dev), cfg)
        top2 = logits[0].topk(2).values
        dec.append(logits[0])
        margins.append((top2[0] - top2[1]).item())
        toks.append(int(logits.argmax()))
    decoy = [(t + 1) % cfg.vocab_size for t in toks[1:5]]
    tree = build_draft_tree(toks[0], [decoy, toks[1:5]])
    chain_nodes = [0, 5, 6, 7, 8]
    assert [tree.tokens[j] for j in chain_nodes] == toks[:5]

    def padded(values, fill):
        out = torch.full((1, w), fill, dtype=torch.int64)
        out[0, :len(values)] = torch.tensor(values)
        return out.to(dev)

    tokens = padded(tree.tokens, 0)
    depths = padded(tree.depths, 0)
    parents = padded(tree.parents, 0)
    masks = padded(tree.masks, 1).to(torch.int32)
    causal = torch.cumsum(1 << torch.arange(w, device=dev), 0)
    causal = causal.to(torch.int32)[None]
    offsets = torch.tensor([n], dtype=torch.int32, device=dev)
    lens = torch.tensor([tree.n_nodes], dtype=torch.int32, device=dev)
    logits, pools = {}, {}
    for run in ("auto", "plain", "fault"):
        kpc, vpc = base_k.clone(), base_v.clone()
        logits[run], kpc, vpc = llama_prefill_chunk_paged(
            params, tokens, kpc, vpc, tables, offsets, lens, cfg,
            implementation="plain" if run == "plain" else "auto",
            return_all_logits=True, tree_depths=depths,
            tree_masks=causal if run == "fault" else masks)
        logits[run] = logits[run][0, :tree.n_nodes]
        pools[run] = (kpc, vpc)
    kernel_vs_plain = (logits["auto"] - logits["plain"]).abs().amax(1).tolist()
    chain_vs_decode = [(logits["auto"][j] - dec[i]).abs().max().item()
                       for i, j in enumerate(chain_nodes)]
    fault = (logits["fault"] - logits["plain"]).abs().max().item()
    zeros = torch.zeros(1, device=dev)
    n_acc, bonus, path = resolve_tree(
        logits["auto"][None], tokens[:, :tree.n_nodes],
        parents[:, :tree.n_nodes], depths[:, :tree.n_nodes], lens, zeros,
        torch.ones(1, device=dev), zeros.long())
    accepted = int(n_acc[0])
    sure = next((i for i in range(4) if margins[i] <= 2 * LOGITS_TOL), 4)
    accepted_path = path[0, :accepted + 1].tolist()
    kpc, vpc = pools["auto"]
    src, dst = path_moves(offsets, path, n_acc, mp * pg)
    pool_move_rows(kpc, tables, src, dst)
    pool_move_rows(vpc, tables, src, dst)
    after, _, _ = llama_decode_step_paged(
        params, torch.tensor([toks[accepted + 1]], device=dev), kpc, vpc,
        tables, torch.tensor([n + accepted + 1], dtype=torch.int32,
                             device=dev), cfg)
    compact_diff = (after[0] - dec[accepted + 1]).abs().max().item()
    torch.cuda.synchronize()
    finite = all(torch.isfinite(t).all().item()
                 for t in (*logits.values(), *dec, after))
    emit({"phase": "model_spec", "config": "llama3_1b bf16 random seed 0",
          "prompt_tokens": n, "tree": "root + decoy branch (nodes 1-4) + "
          "chain of the decoded tokens (nodes 5-8), width 16",
          "decode_top2_margins": margins,
          "kernel_vs_plain_max_abs_logits_diff_per_node": kernel_vs_plain,
          "chain_node_vs_decode_step_diff": chain_vs_decode,
          "accepted_depth": accepted, "depth_the_margins_guarantee": sure,
          "accepted_path": accepted_path,
          "bonus_is_next_decode_token": int(bonus[0]) == toks[accepted + 1],
          "planted_fault_causal_masks_diff": fault,
          "compacted_decode_vs_sequential_diff": compact_diff,
          "tolerance": LOGITS_TOL, "finite": finite,
          "seconds": time.perf_counter() - t0})
    if not finite or max(kernel_vs_plain) > LOGITS_TOL \
            or max(chain_vs_decode) > LOGITS_TOL:
        raise AssertionError(f"model spec: kernel vs plain {kernel_vs_plain}, "
                             f"chain vs decode {chain_vs_decode} (tolerance "
                             f"{LOGITS_TOL}), finite={finite}")
    if accepted < sure or accepted_path != chain_nodes[:accepted + 1]:
        raise AssertionError(f"model spec: accepted depth {accepted} along "
                             f"{accepted_path}, margins {margins} guarantee "
                             f"{sure} along the chain")
    if fault <= LOGITS_TOL:
        raise AssertionError(f"model spec check passed a planted fault: "
                             f"causal-mask logits diff {fault}")
    if compact_diff > LOGITS_TOL:
        raise AssertionError(f"model spec: decode after compaction differs "
                             f"from the sequential step by {compact_diff}")
    del params, logits, pools, kp, vp, base_k, base_v
    torch.cuda.empty_cache()


def phase_model_int8(dev) -> None:
    """llama3_1b on one int8 pool, kernels vs plain, at full width.

    Two prompts (256 and 100 tokens) through flash prefill, whose K/V
    the pool stores quantized (``scatter_chunk_kv``); 3 decode steps; a
    32-token chunk after that history; and one verify of a 9-node draft
    tree (root + two 4-token branches) after the chunk, in the 16-wide
    bucket. Each call runs through the kernels (their int8 branches) and
    through the plain versions, each path on its own pool; both decode
    the kernel path's greedy tokens. Logits must agree within LOGITS_TOL
    (``phase_model``'s reasoning: the two paths read the same codes and
    scales and differ in the kernels' bf16 rounding of P and the order
    of sums). The same calls through the kernels on a bf16 pool give the
    int8-vs-bf16 pool difference, recorded and not gated: it is the
    quantization's, not a kernel's.
    """
    import torch
    from gofr_tpu_torch.models.llama import (LlamaConfig,
                                             llama_decode_step_paged,
                                             llama_init,
                                             llama_prefill_chunk_paged,
                                             llama_prefill_last, make_pool)
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention,
                                                    paged_tree_attention)
    from gofr_tpu_torch.ops.paged_kv import (scatter_chunk_kv,
                                             scatter_chunk_kv_plain)
    from gofr_tpu_torch.serving.spec import build_draft_tree

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    t0 = time.perf_counter()
    p, s, pg, c, w = 2, 256, 64, 32, 16
    tokens = torch.randint(0, cfg.vocab_size, (p, s), generator=gen,
                           device=dev)
    chunk_tokens = torch.randint(0, cfg.vocab_size, (p, c), generator=gen,
                                 device=dev)
    lens = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    mp = -(-(s + 3 + c + w) // pg)
    tables = torch.arange(p * mp, dtype=torch.int32,
                          device=dev).reshape(p, mp)
    draft = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                          device=dev).tolist()
    tree = build_draft_tree(7, [draft[:4], draft[4:]])

    def padded(values, fill, dtype=torch.int64):
        out = torch.full((p, w), fill, dtype=dtype)
        out[:, :len(values)] = torch.tensor(values, dtype=dtype)
        return out.to(dev)

    tree_tokens, depths = padded(tree.tokens, 0), padded(tree.depths, 0)
    masks = padded(tree.masks, 1, torch.int32)
    kernels = (paged_decode_attention, paged_chunk_attention,
               paged_tree_attention)
    before = {f.__name__: (f.launches, f.launches_int8) for f in kernels}
    results: dict = {}
    step_tokens: list = []
    for run in ("auto", "plain", "bf16_pool"):
        impl = "plain" if run == "plain" else "auto"
        logits, (k, v) = llama_prefill_last(params, tokens, cfg,
                                            kv_lengths=lens,
                                            implementation=impl)
        kp, vp = make_pool(cfg, p * mp, pg, dev,
                           "bf16" if run == "bf16_pool" else "int8")
        zeros = torch.zeros_like(lens)
        (scatter_chunk_kv_plain if impl == "plain" else scatter_chunk_kv)(
            kp, vp, tables, k, v, zeros, lens)
        results[run] = {"prefill": logits}
        cur = lens.clone()
        for step in range(3):
            if run == "auto":
                step_tokens.append(logits.argmax(-1))
            logits, kp, vp = llama_decode_step_paged(
                params, step_tokens[step], kp, vp, tables, cur, cfg,
                implementation=impl)
            results[run][f"decode_{step}"] = logits
            cur = cur + 1
        logits, kp, vp = llama_prefill_chunk_paged(
            params, chunk_tokens, kp, vp, tables, cur,
            torch.full_like(cur, c), cfg, implementation=impl)
        results[run]["chunk"] = logits
        cur = cur + c
        logits, kp, vp = llama_prefill_chunk_paged(
            params, tree_tokens, kp, vp, tables, cur,
            torch.full_like(cur, tree.n_nodes), cfg, implementation=impl,
            return_all_logits=True, tree_depths=depths, tree_masks=masks)
        results[run]["tree"] = logits[:, :tree.n_nodes]
    torch.cuda.synchronize()
    launched = {f.__name__: [f.launches - before[f.__name__][0],
                             f.launches_int8 - before[f.__name__][1]]
                for f in kernels}

    def diffs(run):
        return {key: (results[run][key] - results["plain"][key]).abs().max()
                .item() for key in results["plain"]}

    errs, pool_diff = diffs("auto"), diffs("bf16_pool")
    finite = all(torch.isfinite(t).all().item()
                 for r in results.values() for t in r.values())
    emit({"phase": "model_int8", "config": "llama3_1b bf16 weights random "
          "seed 0, int8 KV pool", "prefill": "P=2 S=256 kv_lengths 256/100",
          "then": "3 decode steps, a 32-token chunk, a 9-node tree verify",
          "kernel_vs_plain_max_abs_logits_diff": errs,
          "int8_vs_bf16_pool_max_abs_logits_diff_not_gated": pool_diff,
          "launches_bf16_int8_per_kernel": launched,
          "tolerance": LOGITS_TOL, "finite": finite,
          "seconds": time.perf_counter() - t0})
    if not finite or max(errs.values()) > LOGITS_TOL:
        raise AssertionError(f"model_int8 kernels vs plain: logits diff "
                             f"{errs} (tolerance {LOGITS_TOL}), "
                             f"finite={finite}")
    if any(n_int8 < 1 for _, n_int8 in launched.values()):
        raise AssertionError(f"model_int8: an int8 kernel never launched: "
                             f"{launched}")
    del params, results
    torch.cuda.empty_cache()


def phase_model_wq(dev, smi_line: str) -> None:
    """llama3_1b with int8 and then int4 weights (``quantize_llama_*`` of
    the seed-0 bf16 weights), at full width, kernels vs plain.

    Two prompts (256 and 100 tokens) through ``llama_prefill_last``, one
    ``llama_decode_step_paged`` and one 64-token chunk after that
    history (``llama_prefill_chunk_paged``), once with
    ``implementation="auto"`` (the attention kernels, and the quantized
    products through ``wq_gemm`` wherever the M rule sends them: every
    decode product, the prefill's 512-row and the chunk's 128-row
    products and every head) and
    once with ``"plain"`` (every quantized product dequantized into a
    scratch, then ``torch.matmul``), each on its own bf16 pool; both
    decode the kernel path's greedy token. Logits must agree within
    LOGITS_TOL: the two paths read the same codes and scales and differ
    in the order of float32 sums and in the attention kernels' rounding.
    The decode step must launch ``wq_gemm`` 7 x 16 + 1 times (every
    backbone product and the head) and run the plain version none; the
    planted fault (``wq_gemm`` handed scales shifted by one channel) must
    move the decode logits by more than LOGITS_TOL. Then the decode graph
    (``serve_config``, K = 8) with the quantized weights: replay vs the
    uncaptured pass bit for bit, the stale-tables fault must not agree,
    and the graph's launches per replay hold 8 x 113 ``wq_gemm``."""
    from unittest import mock

    import torch
    from gofr_tpu_torch.models.llama import (LlamaConfig,
                                             llama_decode_step_paged,
                                             llama_init,
                                             llama_prefill_chunk_paged,
                                             llama_prefill_last, make_pool)
    from gofr_tpu_torch.ops import quant as quant_module
    from gofr_tpu_torch.ops.paged_kv import (scatter_chunk_kv,
                                             scatter_chunk_kv_plain)
    from gofr_tpu_torch.serving.app import serve_config
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    p, s, pg, c = 2, 256, 64, 64
    tokens = torch.randint(0, cfg.vocab_size, (p, s), generator=gen,
                           device=dev)
    chunk_tokens = torch.randint(0, cfg.vocab_size, (p, c), generator=gen,
                                 device=dev)
    lens = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    mp = -(-(s + 1 + c) // pg)
    tables = torch.arange(p * mp, dtype=torch.int32,
                          device=dev).reshape(p, mp)
    wq_gemm, plain_fn = quant_module.wq_gemm, quant_module.wq_gemm_plain
    per_step = 7 * cfg.n_layers + 1
    t0 = time.perf_counter()
    for form in ("int8", "int4"):
        counter = "launches_int4" if form == "int4" else "launches"
        qparams = getattr(quant_module, f"quantize_llama_{form}")(params)
        plain_calls = []

        def counted_plain(*a, **kw):
            plain_calls.append(1)
            return plain_fn(*a, **kw)

        def shifted(x, w, **kw):
            bad = {"q": w["q"], "s": torch.roll(w["s"].reshape(-1), 1)
                   .reshape(w["s"].shape).contiguous()}
            return wq_gemm(x, bad, **kw)

        # the wrapper counts on the module's ``wq_gemm``: the stand-in
        # carries the counters while it is patched in
        shifted.launches = shifted.launches_int4 = 0

        results: dict = {}
        step_token = None
        decode_launches = decode_plain = None
        for run in ("auto", "plain", "fault"):
            impl = "plain" if run == "plain" else "auto"
            logits, (k, v) = llama_prefill_last(qparams, tokens, cfg,
                                                kv_lengths=lens,
                                                implementation=impl)
            kp, vp = make_pool(cfg, p * mp, pg, dev)
            (scatter_chunk_kv_plain if impl == "plain" else scatter_chunk_kv)(
                kp, vp, tables, k, v, torch.zeros_like(lens), lens)
            if step_token is None:
                step_token = logits.argmax(-1)
            setattr(wq_gemm, counter, 0)
            plain_calls.clear()
            with mock.patch.object(quant_module, "wq_gemm_plain",
                                   counted_plain), \
                    mock.patch.object(quant_module, "wq_gemm",
                                      shifted if run == "fault"
                                      else wq_gemm):
                step, kp, vp = llama_decode_step_paged(
                    qparams, step_token, kp, vp, tables, lens, cfg,
                    implementation=impl)
                if run == "auto":
                    torch.cuda.synchronize()
                    decode_launches = getattr(wq_gemm, counter)
                    decode_plain = len(plain_calls)
                chunk, kp, vp = llama_prefill_chunk_paged(
                    qparams, chunk_tokens, kp, vp, tables, lens + 1,
                    torch.full_like(lens, c), cfg, implementation=impl)
            results[run] = [logits, step, chunk]
        torch.cuda.synchronize()

        def diffs(run):
            return [(a - b).abs().max().item()
                    for a, b in zip(results[run], results["plain"])]

        errs, fault = diffs("auto"), diffs("fault")
        finite = all(torch.isfinite(t).all().item()
                     for ts in results.values() for t in ts)
        engine = llama_engine(params, cfg, serve_config(cfg), device=dev,
                              quantize=form)
        rng = torch.Generator().manual_seed(0)
        reqs = [engine.submit(torch.randint(0, cfg.vocab_size, (n,),
                                            generator=rng).tolist(),
                              SamplingParams(temperature=0.0,
                                             max_new_tokens=512))
                for n in (21, 151, 401, 901)]
        engine._admit()
        if any(r.error or r.pending_prefill for r in reqs):
            raise AssertionError(f"model_wq: admission failed "
                                 f"{[r.error for r in reqs]}")
        case = _graph_case(engine, "greedy")
        replay_wq = case["launches_per_replay"].get(f"wq_gemm.{counter}", 0)
        emit({"phase": "model_wq", "card": smi_line, "form": form,
              "config": "llama3_1b random seed 0, weights quantized on the "
                        "card", "prefill": "P=2 S=256 kv_lengths 256/100",
              "decode_steps": 1, "chunk": f"P=2 x {c} after the history",
              "max_abs_logits_diff_prefill_decode_chunk": errs,
              "tolerance": LOGITS_TOL, "finite": finite,
              "decode_step_wq_gemm_launches": decode_launches,
              "decode_step_plain_products": decode_plain,
              "planted_fault": "scales_shifted_one_channel",
              "planted_fault_diff_prefill_decode_chunk": fault,
              "weight_bytes": quant_module.quantized_bytes(qparams),
              "graph": case, "graph_wq_gemm_per_replay": replay_wq,
              "seconds": time.perf_counter() - t0})
        if not finite or max(errs) > LOGITS_TOL:
            raise AssertionError(f"model_wq {form}: logits diff {errs} "
                                 f"(tolerance {LOGITS_TOL}), finite={finite}")
        if decode_launches != per_step or decode_plain:
            raise AssertionError(f"model_wq {form}: the decode step ran "
                                 f"{decode_launches} wq_gemm launches (want "
                                 f"{per_step}) and {decode_plain} plain "
                                 f"products (want 0)")
        if fault[1] <= LOGITS_TOL:
            raise AssertionError(f"model_wq {form} passed a planted fault: "
                                 f"decode diff {fault[1]}")
        if not case["bit_equal"] or case["planted_fault_stale_tables_bit_equal"]:
            raise AssertionError(f"model_wq {form}: graph replay vs "
                                 f"uncaptured: {case}")
        steps = engine._tokens_per_pass
        if replay_wq != steps * per_step:
            raise AssertionError(f"model_wq {form}: {replay_wq} wq_gemm "
                                 f"launches a replay, want {steps} x "
                                 f"{per_step}")
        del engine, qparams, results
        gc.collect()
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def _dispatch_device_ms(engine, prompts) -> dict:
    """Device ms of one decode dispatch (a graph replay of T steps over
    every slot) of ``engine`` with ``prompts`` admitted greedily, and
    the host ms of the same replay with its readout (CUDA events)."""
    import torch
    from gofr_tpu_torch.serving.engine import SamplingParams
    reqs = [engine.submit(pr, SamplingParams(temperature=0.0,
                                             max_new_tokens=1024))
            for pr in prompts]
    engine._admit()
    if any(r.error or r.pending_prefill for r in reqs):
        raise AssertionError(f"dispatch: admission failed "
                             f"{[r.error for r in reqs]}")
    engine._decode_step()                # captures
    for i, req in enumerate(engine.active):
        if req is not None:              # rows for the timed dispatches
            engine._alloc_pages(i, int(engine.lengths[i])
                                + 40 * engine._tokens_per_pass)
    engine._sync_tables()
    graph = engine._decode_graph

    def replay():
        graph.run(engine.k_cache, engine.v_cache, True)

    out = {"steps_per_dispatch": engine._tokens_per_pass,
           "device_ms": device_ms(replay, warmup=2, iters=10),
           "ms": time_ms(replay, warmup=1, iters=10)}
    torch.cuda.synchronize()
    return out


def phase_serve_wq(dev, smi_line: str) -> dict:
    """The ``serve`` cell's three waves with weight-only quantized
    weights on the bf16 pool: ``phase_serve(quantize="int8")``, then
    ``"int4"``, each after ``engine.warmup()``. Then one decode
    dispatch's device ms at the serve engine's shape (4 greedy slots of
    21 / 151 / 401 / 901 random prompt tokens, K = 8) for bf16, int8 and
    int4 weights, in one process, and the weight bytes of each. Returns
    the two runs' ``wq_gemm`` launch counts."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.ops.quant import (quantize_llama_int4,
                                          quantize_llama_int8,
                                          quantized_bytes)
    from gofr_tpu_torch.serving.app import serve_config
    from gofr_tpu_torch.serving.glue import llama_engine
    # only the wq_gemm counts: the attention and kv_write rows keep those
    # of the bf16 serve run, zeroed just before it
    launches = {}
    for form in ("int8", "int4"):
        own = phase_serve(dev, smi_line, quantize=form)["launches"]
        launches.update({k: v for k, v in own.items()
                         if k.startswith("wq_gemm")})
    cfg = LlamaConfig.llama3_1b()
    params = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
               .tolist() for n in (21, 151, 401, 901)]
    dispatch = {}
    for form in ("bf16", "int8", "int4"):
        tree = {"bf16": params, "int8": quantize_llama_int8(params),
                "int4": quantize_llama_int4(params)}[form]
        engine = llama_engine(tree, cfg, serve_config(cfg), device=dev)
        dispatch[form] = {**_dispatch_device_ms(engine, prompts),
                          "weight_bytes": quantized_bytes(tree)}
        del engine, tree
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_wq_dispatch", "card": smi_line,
          "config": "llama3_1b random seed 0, app.serve_config, 4 greedy "
                    "slots 21/151/401/901", "dispatch": dispatch})
    del params
    torch.cuda.empty_cache()
    return launches


#: a byte-level BPE tokenizer.json for the checkpoint phase: the 256
#: bytes, a few English merges, the Llama-3 specials
_MERGES = ("Ġ t", "h e", "Ġt he", "Ġ a", "i n", "e r", "o n", "Ġ s", "r e",
           "a t", "e n", "Ġ c", "o r", "Ġ w", "Ġ p", "a n", "Ġ b", "Ġ f")


def _write_tokenizer(path) -> None:
    from gofr_tpu_torch.serving.tokenizer import _byte_level_table
    chars = {b: ch for ch, b in _byte_level_table().items()}
    vocab = {chars[b]: b for b in range(256)}
    for m, pair in enumerate(_MERGES):
        vocab[pair.replace(" ", "")] = 256 + m
    added = [{"id": 128000, "content": "<|begin_of_text|>"},
             {"id": 128001, "content": "<|end_of_text|>"}]
    Path(path).write_text(json.dumps({
        "model": {"type": "BPE", "vocab": vocab, "merges": list(_MERGES)},
        "added_tokens": added}))


def phase_checkpoint(dev, smi_line: str) -> None:
    """Real-checkpoint serving end to end: the seed-0 llama3_1b bf16
    weights written as an HF checkpoint (``save_llama_checkpoint``, two
    shards and their index) with a ``tokenizer.json`` this script writes,
    in a temporary directory; the app's engine booted from it as
    ``python -m gofr_tpu_torch.serving.app`` boots it (``app_engine``
    with ``MODEL_PATH``, ``MODEL_QUANT=int8``, ``MODEL_MAX_SEQ=2048``:
    quantize on load) behind the HTTP server, and one greedy ``POST
    /chat``. Its tokens must equal, bit for bit, those of the in-memory
    engine (``llama_engine(..., quantize="int8")`` on the same weights
    and the same engine config) on the same prompt ids, and
    ``usage.prompt_tokens`` must be the BPE count (fewer than the byte
    tokenizer's)."""
    import tempfile

    import torch
    from gofr_tpu_torch.models.hf_checkpoint import save_llama_checkpoint
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serving.app import (app_engine, build_server,
                                            serve_config)
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    cfg = LlamaConfig.llama3_1b()
    params = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = ("the quick brown fox jumps over the lazy dog; a paged cache "
              "keeps every token in place while the server answers")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        save_llama_checkpoint(params, cfg, tmp, shards=2)
        _write_tokenizer(Path(tmp) / "tokenizer.json")
        files = sorted(p.name for p in Path(tmp).iterdir())
        write_s = time.perf_counter() - t0
        engine, tokenizer, _ = app_engine(
            {"MODEL_PATH": tmp, "MODEL_QUANT": "int8",
             "MODEL_MAX_SEQ": "2048"}, device=dev)
        load_s = time.perf_counter() - t0 - write_s
    server = build_server(engine, tokenizer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    engine.start()
    thread.start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}"
                             f"/chat", {"prompt": prompt, "max_tokens": 32,
                                        "temperature": 0})
        config = engine.config
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ids = tokenizer.encode(prompt)
    twin = llama_engine(params, cfg, serve_config(
        cfg, max_seq=2048, eos_id=tokenizer.eos_id), device=dev,
        quantize="int8")
    twin.start()
    try:
        req = twin.submit_sync(ids, SamplingParams(temperature=0.0,
                                                   max_new_tokens=32), 600)
    finally:
        twin.stop()
    got = body["data"]["tokens"] if status == 201 else None
    usage = body["data"]["usage"] if status == 201 else {}
    emit({"phase": "checkpoint", "card": smi_line,
          "config": "llama3_1b bf16 random seed 0 as an HF checkpoint, two "
                    "shards, MODEL_QUANT=int8 MODEL_MAX_SEQ=2048",
          "files": files, "write_s": write_s, "load_s": load_s,
          "status": status, "engine_max_seq": config.max_seq,
          "eos_id": config.eos_id, "prompt_bytes": len(prompt.encode()),
          "prompt_tokens": usage.get("prompt_tokens"),
          "tokens": got, "in_memory_tokens": list(req.generated),
          "bit_equal": got == list(req.generated)})
    if status != 201 or req.error:
        raise AssertionError(f"checkpoint: status {status}, in-memory "
                             f"error {req.error}")
    if got != list(req.generated):
        raise AssertionError("checkpoint: the app's tokens differ from the "
                             "in-memory int8 engine's")
    if usage["prompt_tokens"] != len(ids) or \
            usage["prompt_tokens"] >= len(prompt.encode()):
        raise AssertionError(f"checkpoint: prompt_tokens "
                             f"{usage['prompt_tokens']}: the BPE tokenizer "
                             f"is not live")
    del twin, params
    gc.collect()
    torch.cuda.empty_cache()


def _pools_of(engine) -> list:
    out = []
    for pool in (engine.k_cache, engine.v_cache):
        out += [pool["q"], pool["s"]] if isinstance(pool, dict) \
            else [pool]
    return out


def _graph_case(engine, batch: str) -> dict:
    """One decode dispatch of ``engine`` (its requests admitted) replayed
    and, on the same state and cloned pools, run uncaptured: whether the
    two agree bit for bit, whether a replay fed stale tables (the planted
    fault) does, ms per dispatch of each, launches per replay."""
    import torch
    from gofr_tpu_torch.serving.decode_graph import _counts
    graph = engine._decode_graph
    greedy = batch == "greedy"
    engine._decode_step()            # a real dispatch (captures once)
    # pages for the dispatch under test, as the next dispatch's
    # growth would allocate them
    for i, req in enumerate(engine.active):
        if req is not None:
            engine._alloc_pages(i, int(engine.lengths[i])
                                + engine._tokens_per_pass)
    engine._sync_tables()
    saved = graph.save()
    pools = [t.clone() for t in _pools_of(engine)]

    def rewind():
        graph.restore(saved)
        for live, old in zip(_pools_of(engine), pools):
            live.copy_(old)

    graph.body(engine.k_cache, engine.v_cache, greedy)
    want = graph.save()
    want_pools = [t.clone() for t in _pools_of(engine)]
    rewind()
    before = _counts()
    graph.run(engine.k_cache, engine.v_cache, greedy)
    launched = {f"{fn.__name__}.{attr}": n - before[(fn, attr)]
                for (fn, attr), n in _counts().items()
                if n != before[(fn, attr)]}
    got = graph.save()

    def agrees(state, pool_leaves):
        return (all(torch.equal(state[k], want[k]) for k in want
                    if k != "generator")
                and all(torch.equal(a, b) for a, b in
                        zip(pool_leaves, want_pools)))

    equal = agrees(got, _pools_of(engine))
    rewind()                         # the planted fault: stale tables
    graph.tables.copy_(saved["tables"][[1, 0, *range(2, len(
        saved["tables"]))]])
    graph.run(engine.k_cache, engine.v_cache, greedy)
    fault_equal = agrees(graph.save(), _pools_of(engine))
    rewind()
    replay_ms = time_ms(lambda: graph.run(engine.k_cache,
                                          engine.v_cache, greedy),
                        warmup=2, iters=10)
    rewind()
    eager_ms = time_ms(lambda: graph.body(engine.k_cache,
                                          engine.v_cache, greedy),
                       warmup=1, iters=5)
    rewind()
    return {"batch": batch, "bit_equal": equal,
            "planted_fault_stale_tables_bit_equal": fault_equal,
            "replay_ms_per_dispatch": replay_ms,
            "uncaptured_ms_per_dispatch": eager_ms,
            "launches_per_replay": launched,
            "graph_captures": graph.captures,
            "graph_capture_s": graph.capture_s}


def phase_decode_graph(dev, smi_line: str) -> None:
    """The compiled decode dispatch at ``llama3_1b`` on ``serve_config``
    (8 slots, 64-row pages, 256 bf16 / 481 int8 pages), K = 8, M = 1 and
    M = 2, each pool form: one engine each, driven on this thread. Four
    greedy prompts (21 / 151 / 401 / 901 random tokens, seed 0) are
    prefilled and one dispatch runs (the first captures); then the
    next dispatch is replayed and, on the same state and cloned pools,
    run uncaptured (``DecodeGraph.body``, the eager loop at max_batch
    rows): tokens, state buffers and both pools must agree bit for bit.
    Then two sampled prompts (temperature 0.8, top-p 0.9, top-k 40) join
    and the same check runs on the mixed batch (the sampled graph, noise
    from the engine's generator, same state). Planted fault: the replay
    fed a stale tables buffer (two slots' rows swapped, as a missed
    upload after an admission would leave it) must not agree. Printed:
    ms per dispatch of the replay and of the uncaptured pass (CUDA
    events, host included), launches per dispatch, captures."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serving.app import serve_config
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    rng = torch.Generator().manual_seed(0)
    greedy_prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                      .tolist() for n in (21, 151, 401, 901)]
    sampled_prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                       .tolist() for n in (64, 300)]

    cases = []
    t0 = time.perf_counter()
    for kv_dtype in ("bf16", "int8"):
        for m in (1, 2):
            engine = llama_engine(params, cfg, serve_config(
                cfg, kv_dtype=kv_dtype, decode_passes_per_dispatch=m),
                device=dev)
            for batch, prompts, sp in (
                    ("greedy", greedy_prompts,
                     SamplingParams(temperature=0.0, max_new_tokens=512)),
                    ("mixed", sampled_prompts,
                     SamplingParams(temperature=0.8, top_p=0.9, top_k=40,
                                    max_new_tokens=512))):
                reqs = [engine.submit(p, sp) for p in prompts]
                engine._admit()
                if any(r.error or r.pending_prefill for r in reqs):
                    raise AssertionError(f"decode_graph: admission failed "
                                         f"{[r.error for r in reqs]}")
                case = _graph_case(engine, batch)
                case.update(kv_dtype=kv_dtype, decode_passes_per_dispatch=m,
                            steps_per_dispatch=engine._tokens_per_pass)
                emit({"phase": "decode_graph_case", **case})
                cases.append(case)
            del engine
            gc.collect()             # its graphs go now, not mid-capture
            torch.cuda.empty_cache()
    emit({"phase": "decode_graph", "card": smi_line,
          "config": "llama3_1b bf16 random seed 0, app.serve_config, K=8",
          "cases": len(cases), "seconds": time.perf_counter() - t0})
    bad = [c for c in cases if not c["bit_equal"]]
    if bad:
        raise AssertionError(f"decode_graph: replay differs from the "
                             f"uncaptured pass: {bad}")
    missed = [c for c in cases if c["planted_fault_stale_tables_bit_equal"]]
    if missed:
        raise AssertionError(f"decode_graph check passed a planted fault "
                             f"(stale tables): {missed}")
    # every step's new rows went through the fused write, once a layer
    unfused = [c for c in cases if c["launches_per_replay"].get(
        "rope_kv_write.launches" + ("_int8" if c["kv_dtype"] == "int8"
                                    else "")) != cfg.n_layers
        * c["steps_per_dispatch"] or any(k.startswith("kv_write.")
                                         for k in c["launches_per_replay"])]
    if unfused:
        raise AssertionError(f"decode_graph: a replay did not write through "
                             f"rope_kv_write once a layer and step: "
                             f"{unfused}")
    del params
    torch.cuda.empty_cache()


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _pool_bytes(engine) -> int:
    """Device bytes of an engine's K and V pools, every leaf."""
    leaves = []
    for pool in (engine.k_cache, engine.v_cache):
        leaves += list(pool.values()) if isinstance(pool, dict) else [pool]
    return sum(t.numel() * t.element_size() for t in leaves)


def phase_serve(dev, smi_line: str, bf16: dict | None = None,
                quantize: str | None = None) -> dict:
    """The port's app on a free port, serving ``app.serve_config`` (8
    slots, max_seq 2048, 64-row pages, buckets to 1024, prefix cache
    on); with ``bf16`` (the bf16 run's result) the same through
    ``serve_config(kv_dtype="int8")``, the ``serve_int8`` cell, at the
    default budget: the bf16 pool's bytes. Three waves of greedy ``POST
    /chat``, 32 new tokens each:

    1. the four concurrent prompts of 21 / 151 / 401 / 901 tokens (flash
       group prefill, then paged decode);
    2. one 1801-token prompt alone: wider than every bucket, so it walks
       in two chunks (1024, 777) through the chunk kernel, unclamped;
    3. three concurrent prompts that share a page-aligned prefix with a
       wave-1 prompt or the long one (896, 384 and 1792 cached rows):
       prefix-cache hits that walk only their suffix.

    The launch counters of the run's kernels (flash, and paged decode
    and chunk for the pool's form) are zeroed before wave 1 and read
    after wave 3; each must have risen, and the paged counters of the
    other form must not have. The int8 run also needs at least 1.8x the
    bf16 pool's pages in no more bytes, and records each answer's common
    prefix with the bf16 run's (not gated: a random model has near-ties,
    and the int8 pool moves the logits by more than their gaps).

    With ``quantize`` ("int8" / "int4") the same waves serve weight-only
    quantized weights on the bf16 pool, the ``serve_wq`` cell, after
    ``engine.warmup()`` (the graphs captured before traffic):
    ``wq_gemm``'s counter of the form must rise too, and the weight bytes
    (``quantized_bytes``) are printed."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import (kv_write, rope_kv_write,
                                             scatter_chunk_kv)
    from gofr_tpu_torch.ops.quant import quantized_bytes, wq_gemm
    from gofr_tpu_torch.serving.app import (build_engine, build_server,
                                            serve_config)
    kv_dtype = "bf16" if bf16 is None else "int8"
    phase = ("serve" if bf16 is None else "serve_int8") if quantize is None \
        else f"serve_wq_{quantize}"
    suffix, other = ("", "_int8") if bf16 is None else ("_int8", "")
    # the run's kernels, and the paged ones of the other pool form
    own = {"flash_attention": (flash_attention, "launches")}
    others = {}
    for fn in (paged_decode_attention, paged_chunk_attention, rope_kv_write,
               scatter_chunk_kv):
        own[fn.__name__ + suffix] = (fn, "launches" + suffix)
        others[fn.__name__ + other] = (fn, "launches" + other)
    # the per-layer write entry: the fused one took the model steps' write
    off_path = {"kv_write": (kv_write, "launches"),
                "kv_write_int8": (kv_write, "launches_int8")}
    if quantize is not None:
        wq_attr = "launches_int4" if quantize == "int4" else "launches"
        own["wq_gemm" + ("_int4" if quantize == "int4" else "")] = (
            wq_gemm, wq_attr)
    cfg = LlamaConfig.llama3_1b()
    engine = build_engine(cfg, device=dev, seed=0,
                          engine_config=serve_config(cfg, kv_dtype=kv_dtype),
                          quantize=quantize)
    pages, pool_bytes = engine._n_pages, _pool_bytes(engine)
    warmup_s = engine.warmup() if quantize is not None else None
    warm_capture_s = engine.stats["graph_capture_s"]
    server = build_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    engine.start()
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/chat"
    waves = _serve_waves()
    long_prompt = waves[1][0]
    # each hit's twin in `answers`: the 901-token, 401-token and long prompts
    twins = [3, 2, 4]
    answers: list = []
    walls = []

    def ask(prompt, out, i):
        out[i] = _post(url, {"prompt": prompt, "max_tokens": 32,
                             "temperature": 0})

    try:
        for fn, attr in (*own.values(), *others.values(),
                         *off_path.values()):
            setattr(fn, attr, 0)
        for wave in waves:
            got: list = [None] * len(wave)
            t0 = time.perf_counter()
            workers = [threading.Thread(target=ask, args=(p, got, i))
                       for i, p in enumerate(wave)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            walls.append(time.perf_counter() - t0)
            answers += got
        launches = {name: getattr(fn, attr) for name, (fn, attr) in own.items()}
        other_launches = {name: getattr(fn, attr)
                          for name, (fn, attr) in others.items()}
        off_path_launches = {name: getattr(fn, attr)
                             for name, (fn, attr) in off_path.items()}
        stats = dict(engine.stats)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    if any(a is None or a[0] != 201 for a in answers):
        raise AssertionError(f"{phase}: not every answer was 201: {answers}")
    usage = [a[1]["data"]["usage"] for a in answers]
    tokens = [a[1]["data"]["tokens"] for a in answers]
    n_tokens = [len(t) for t in tokens]
    if n_tokens != [32] * len(answers):
        raise AssertionError(f"{phase}: token counts {n_tokens} != 32 each")
    if usage[4]["prompt_tokens"] != len(long_prompt) + 1:
        raise AssertionError(f"{phase}: the long prompt was cut to "
                             f"{usage[4]['prompt_tokens']} tokens")
    if stats["prefix_hits"] < len(waves[2]):
        raise AssertionError(f"{phase}: {stats['prefix_hits']} prefix hits "
                             f"for {len(waves[2])} sharing requests")
    if min(launches.values()) < 1 or any(other_launches.values()) \
            or any(off_path_launches.values()):
        raise AssertionError(f"{phase}: a kernel of the {kv_dtype} pool "
                             f"never launched ({launches}), or one of the "
                             f"other form did ({other_launches}), or the "
                             f"per-layer write did ({off_path_launches})")
    ttft = [u["ttft_ms"] for u in usage]
    out = {"phase": phase, "card": smi_line, "kv_dtype": kv_dtype,
           "pool_pages": pages, "pool_bytes": pool_bytes,
           "requests": len(answers),
           "waves": [len(w) for w in waves], "wall_s_per_wave": walls,
           "prompt_tokens": [u["prompt_tokens"] for u in usage],
           "completion_tokens": n_tokens, "ttft_ms": ttft,
           "prefix_hit_ttft_ms_vs_twin": [[ttft[5 + i], ttft[t]]
                                          for i, t in enumerate(twins)],
           "prefix_hits": stats["prefix_hits"],
           "prefix_evictions": stats["prefix_evictions"],
           "decode_tokens": stats["decode_tokens"],
           "decode_s": stats["decode_s"],
           "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
           **_graph_stats(stats, warm_capture_s),
           "prefill_calls": stats["prefill_calls"],
           "prefill_s": stats["prefill_s"], "launches": launches,
           "launches_of_the_other_pool_form": other_launches,
           "launches_off_the_main_path": off_path_launches}
    if quantize is not None:
        out.update(quantize=quantize, warmup_s=warmup_s,
                   weight_bytes=quantized_bytes(engine.params))
    if bf16 is not None:
        out["pages_vs_bf16_pool"] = pages / bf16["pool_pages"]
        out["bytes_vs_bf16_pool"] = pool_bytes / bf16["pool_bytes"]
        out["common_prefix_with_bf16_answers"] = [
            _common_prefix(a, b) for a, b in zip(tokens, bf16["tokens"])]
    emit(out)
    if bf16 is not None and (pages < 1.8 * bf16["pool_pages"]
                             or pool_bytes > bf16["pool_bytes"]):
        raise AssertionError(f"serve_int8: {pages} pages in {pool_bytes} "
                             f"bytes against the bf16 pool's "
                             f"{bf16['pool_pages']} in {bf16['pool_bytes']}")
    del engine
    torch.cuda.empty_cache()
    return {"launches": {**off_path_launches, **launches}, "tokens": tokens,
            "pool_pages": pages, "pool_bytes": pool_bytes}


def _graph_stats(stats: dict, warm_capture_s: float = 0.0) -> dict:
    """The compiled decode dispatch's counters, and decode tokens/s with
    the one-off graph captures left out of ``decode_s`` (those made
    while serving: ``warm_capture_s`` of them came before, in
    ``warmup``)."""
    keys = ("graph_captures", "graph_replays", "graph_capture_s",
            "sched_syncs", "h2d_transfers")
    out = {k: stats[k] for k in keys}
    out["decode_tokens_per_s_without_capture"] = stats["decode_tokens"] / (
        stats["decode_s"] - stats["graph_capture_s"] + warm_capture_s)
    return out


def _common_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _PrintableTokenizer:
    """The byte tokenizer's encoding, and a decoding that gives every id
    one printable ASCII character (``chr(33 + id % 94)``): a random
    model's ids lie mostly past the byte range, which the byte tokenizer
    decodes to nothing, so its text would be near empty. Here each token
    is one character, and text, deltas and stop sequences are checked
    character for character."""

    def __init__(self) -> None:
        from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
        self._bytes = ByteTokenizer()

    def encode(self, text: str) -> list:
        return self._bytes.encode(text)

    def decode(self, ids) -> str:
        return "".join(chr(33 + int(i) % 94) for i in ids)


def _http_json(port: int, method: str, path: str, body=None,
               headers: dict | None = None):
    """(status, headers with lower-case names, JSON body) of one request,
    with ``headers`` beside its own."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                json.loads(resp.read()))
    finally:
        conn.close()


def _content(event) -> str | None:
    """The text an SSE event carries: a ``/chat`` frame's token text, a
    chat chunk's content delta, a completion chunk's text (None for the
    role chunk, a terminal chunk, an error and ``[DONE]``)."""
    if not isinstance(event, dict):
        return None
    if "token" in event:
        return event["text"]
    choice = (event.get("choices") or [{}])[0]
    if choice.get("finish_reason") is not None:
        return None
    if "delta" in choice:
        return choice["delta"].get("content")
    return choice.get("text") or None


def _open_post(port: int, path: str, body: dict,
               headers: dict | None = None):
    """A raw socket that has sent one POST (no reply read yet), with
    ``headers`` beside its own."""
    import socket
    data = json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    sock.sendall(b"POST %s HTTP/1.1\r\nHost: localhost\r\nContent-Type: "
                 b"application/json\r\nContent-Length: %d\r\n%sConnection: "
                 b"close\r\n\r\n%s" % (path.encode(), len(data),
                                         extra.encode(), data))
    return sock


def _sse_call(port: int, path: str, body: dict,
              close_after: int | None = None,
              first_event: threading.Event | None = None,
              headers: dict | None = None) -> dict:
    """One POST read off a raw socket, chunk by chunk: status, headers,
    each SSE event with its arrival time (s after the request was sent),
    whether the terminating zero-length chunk came. With ``close_after``
    the client closes its socket once that many events carried text
    (``closed_at``: ``time.perf_counter()`` then); ``sent_at``: the wall
    clock when the request left, as ``GenRequest.submitted_at`` reads
    it. ``first_event`` is set once the first event has arrived.
    ``headers`` go with the request (an API key)."""
    t0 = time.perf_counter()
    out = {"events": [], "terminal": False, "closed_at": None,
           "sent_at": time.time()}
    sock = _open_post(port, path, body, headers)
    reader = sock.makefile("rb")
    try:
        out["status"] = int(reader.readline().split()[1])
        headers = {}
        while True:
            line = reader.readline()
            if line in (b"\r\n", b""):
                break
            key, _, value = line.decode().partition(":")
            headers[key.strip().lower()] = value.strip()
        out["headers"] = headers
        if "content-length" in headers:
            out["body"] = json.loads(reader.read(
                int(headers["content-length"])))
            return out
        buf, texts = b"", 0
        while True:
            size_line = reader.readline()
            if not size_line:
                break                     # closed without the zero chunk
            size = int(size_line.strip(), 16)
            if size == 0:
                reader.readline()
                out["terminal"] = True
                break
            buf += reader.read(size)
            reader.read(2)
            now = time.perf_counter() - t0
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                payload = block.decode()[len("data: "):]
                event = payload if payload == "[DONE]" else json.loads(payload)
                out["events"].append((now, event))
                texts += _content(event) is not None
                if first_event is not None:
                    first_event.set()
            if close_after is not None and texts >= close_after:
                out["closed_at"] = time.perf_counter()
                break
    finally:
        reader.close()
        sock.close()
    return out


def _frame_faults(tokens: list, frames: list, decode) -> list:
    """``/chat`` stream frames against the unary answer's tokens."""
    out = []
    if [f["token"] for f in frames] != tokens:
        out.append("frame_tokens")
    if any(f["text"] != decode([f["token"]]) for f in frames):
        out.append("frame_text")
    return out


def _form_faults(sse: dict, chat: bool) -> list:
    """A well-formed OpenAI stream: 200, the role chunk first (chat),
    exactly one terminal chunk just before ``[DONE]``, ``[DONE]`` last,
    the zero-length chunk after it."""
    events = [e for _, e in sse["events"]]
    out = []
    if sse.get("status") != 200:
        out.append("status")
    if chat and not (events and isinstance(events[0], dict)
                     and events[0]["choices"][0]["delta"]
                     == {"role": "assistant"}):
        out.append("role_first")
    finals = [i for i, e in enumerate(events)
              if isinstance(e, dict) and "choices" in e
              and e["choices"][0]["finish_reason"] is not None]
    if finals != [len(events) - 2]:
        out.append("one_terminal_chunk")
    if not events or events[-1] != "[DONE]":
        out.append("done_last")
    if not sse["terminal"]:
        out.append("zero_chunk")
    return out


def _delta_faults(tokens: list, sse: dict, decode, n_new: int) -> list:
    """A ``/v1/completions`` stream: its deltas, joined, are the text of
    ``tokens`` (``n_new`` of them), its terminal chunk says "length",
    and it is well formed."""
    events = [e for _, e in sse["events"]]
    out = []
    if "".join(t for t in map(_content, events) if t is not None) \
            != decode(tokens):
        out.append("delta_text")
    finals = [e["choices"][0]["finish_reason"] for e in events
              if isinstance(e, dict) and "choices" in e
              and e["choices"][0]["finish_reason"] is not None]
    if finals != ["length"] or len(tokens) != n_new:
        out.append("finish_length")
    return out + _form_faults(sse, chat=False)


def _stop_faults(answer: tuple, full: str, stop: str, max_tokens: int) -> list:
    """A unary completion with ``stop``: finish "stop", the text of the
    stopless answer ``full`` cut before the match, fewer tokens."""
    status, _, body = answer
    if status != 201:
        return ["status"]
    out = []
    choice = body["choices"][0]
    if choice["finish_reason"] != "stop":
        out.append("finish_stop")
    if choice["text"] != full[:full.find(stop)] or stop in choice["text"]:
        out.append("text_cut_at_stop")
    if not body["usage"]["completion_tokens"] < max_tokens:
        out.append("completion_below_max")
    return out


def _watch_slots(engine, limit_s: float, since: float) -> list:
    """(seconds since ``since``, busy slots) samples, until no slot is
    busy or ``limit_s`` has passed."""
    samples = []
    while True:
        busy = sum(r is not None for r in engine.active)
        samples.append((time.perf_counter() - since, busy))
        if busy == 0 or samples[-1][0] > limit_s:
            return samples
        time.sleep(0.002)


def _freed_faults(samples: list, limit_s: float) -> list:
    """Some sample within ``limit_s`` saw every slot free."""
    if not any(t <= limit_s and busy == 0 for t, busy in samples):
        return [f"slots_free_within_{limit_s}s"]
    return []


def _queued_faults(req, cancel_s: float) -> list:
    """A request whose client left while it waited: cancelled within
    2 s, and never given a slot or a token."""
    out = []
    if not req.cancelled or cancel_s > 2.0:
        out.append("cancelled_within_2s")
    if req.slot != -1 or req.generated or req.admit_order != -1:
        out.append("never_slotted")
    return out


def _refusal_faults(answer: tuple, status: int, err_type: str) -> list:
    """A typed refusal: its status, a whole-second ``Retry-After`` of at
    least 1, the OpenAI error type in ``details``."""
    got, headers, body = answer
    out = []
    if got != status:
        out.append("status")
    if not headers.get("retry-after", "").isdigit() \
            or int(headers["retry-after"]) < 1:
        out.append("retry_after")
    if ((body.get("error") or {}).get("details") or {}).get("type") \
            != err_type:
        out.append("error_type")
    return out


def _starve_faults(run: dict, calm: dict) -> list:
    """The starvation run against the run without preemption: one
    preemption on both counters, every request complete, the victim's
    tokens equal up to its preemption point, the others' all."""
    out = []
    if run["scheduler_preemptions"] < 1 or run["engine_preemptions"] < 1:
        out.append("preempted")
    if run["errors"] or run["n_tokens"] != calm["n_tokens"]:
        out.append("complete")
    for i, (got, want) in enumerate(zip(run["tokens"], calm["tokens"])):
        n = run["folded"][i] or len(want)
        if got[:n] != want[:n]:
            out.append(f"tokens_{i}")
    return out


def _counter_faults(launches: dict) -> list:
    out = [f"{k}_launched" for k, n in launches.items()
           if k != "kv_write" and n < 1]
    if launches["kv_write"]:
        out.append("kv_write_off_path")
    return out


def phase_serve_stream(dev, smi_line: str, cfg=None) -> None:
    """The serving surface on the card: the port's app with ``/chat`` and
    the OpenAI routes installed as ``app.main`` installs them, on
    ``cfg`` (default ``llama3_1b``; random weights, seed 0) and
    ``serve_config`` with the prefix cache off: a hit walks a repeated
    prompt's suffix through the chunk kernel, whose bf16 logits may flip
    a near-tie, and (a) holds three answers to one prompt to one path.
    Prompts use the byte tokenizer; every id decodes to one printable
    character (``_PrintableTokenizer``). Greedy throughout.

    (a) prompts of 21, 401 and 1801 tokens (the last walked through the
        chunk kernel), 32 new tokens, one request at a time: the unary
        ``/chat`` answers 201; its tokens are the ``/chat`` stream's frame
        tokens bit for bit, each frame's text ``decode([token])``, then
        ``[DONE]``; the ``/v1/completions`` stream's deltas joined are
        ``decode(tokens)``, its finish "length".
    (b) four concurrent ``/v1/chat/completions`` streams (serve's wave-1
        prompt lengths 21 / 151 / 401 / 901 after the chat template):
        well formed (role chunk first, one terminal chunk, ``[DONE]``
        last, the zero-length chunk); client TTFT (the first content
        event) beside the engine's, the gaps between content events p50 /
        p99, decode tokens/s; then the same wave as unary ``/chat``, and
        the streamed / unary ratio of decode tokens/s.
    (c) ``/v1/completions`` with a 3-character stop that first occurs in
        (a)'s 401-token text past its 10th character: finish "stop", the
        text cut before the match, fewer tokens than ``max_tokens``, no
        slot busy within 0.5 s.
    (d) a chat stream of ``max_tokens`` 1024 whose client closes after 3
        content events: no slot busy within 2 s, fewer than 128 tokens
        decoded; a ``/chat`` stream queued behind 8 busy slots whose
        client leaves: cancelled within 2 s, never given a slot.
    (e) an engine with ``max_waiting=1`` on the same weights, the batch
        full and one request waiting: ``/v1/completions`` answers 503
        ``server_error`` with ``Retry-After``; under ``RateLimit(rps=
        0.5)`` the second of two rapid requests 429 ``rate_limit_error``
        with ``Retry-After``.
    (f) 8 background requests (301-token prompts, 1536 new tokens), then
        one interactive one once all 8 decode, on ``serve_config`` with
        ``SchedulerConfig(starvation_s=0.25)`` and with starvation
        preemption off (``starvation_s=0``): with it, a preemption on the
        scheduler's and the engine's counters, every request complete,
        the victim's tokens equal to the run without it up to its
        preemption point, the others' all of them; the interactive TTFT
        of both runs.
    (g) the launch counters, zeroed before (a) and read after (f): flash,
        paged decode, paged chunk, ``rope_kv_write`` and the slab write
        (``scatter_chunk_kv``) rise, the per-layer ``kv_write`` stays 0.

    Each check is also shown a planted fault and must reject it."""
    import numpy as np
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import (kv_write, rope_kv_write,
                                             scatter_chunk_kv)
    from gofr_tpu_torch.serving.app import (build_engine, build_server,
                                            serve_config)
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.openai_compat import install_openai_routes
    from gofr_tpu_torch.serving.scheduler import RateLimit, SchedulerConfig
    cfg = cfg or LlamaConfig.llama3_1b()
    t_phase = time.perf_counter()
    counters = {"flash_attention": (flash_attention, "launches"),
                "paged_decode_attention": (paged_decode_attention,
                                           "launches"),
                "paged_chunk_attention": (paged_chunk_attention, "launches"),
                "rope_kv_write": (rope_kv_write, "launches"),
                "scatter_chunk_kv": (scatter_chunk_kv, "launches"),
                "kv_write": (kv_write, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    tok = _PrintableTokenizer()
    greedy = {"temperature": 0}
    failed: dict = {}
    planted: dict = {}
    out: dict = {"phase": "serve_stream", "card": smi_line}
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")

    def judge(name, faults, planted_faults):
        failed[name], planted[name] = faults, planted_faults

    def serving(engine):
        """The app over ``engine`` on a free port, submits recorded."""
        server = build_server(engine, tok, port=0)
        install_openai_routes(server, engine, tok, model="llama3_1b")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        made, inner = [], engine.submit

        def submit(*args, **kwargs):
            made.append(inner(*args, **kwargs))
            return made[-1]

        engine.submit = submit
        return server, thread, server.server_address[1], made

    def fill_slots(engine, n_new):
        """Every slot busy with a long request, admitted one at a time."""
        held = []
        for _ in range(engine.config.max_batch):
            held.append(engine.submit([1, 2, 3], SamplingParams(
                temperature=0.0, max_new_tokens=n_new)))
            deadline = time.time() + 60
            while time.time() < deadline and not held[-1].generated:
                time.sleep(0.002)
        return held

    engine = build_engine(cfg, device=dev, seed=0, engine_config=serve_config(
        cfg, prefix_cache=False))
    params = engine.params
    server, thread, port, made = serving(engine)
    engine.start()
    try:
        # (a) one request at a time, three routes per prompt
        texts, rows = {}, []
        for n in (21, 401, 1801):
            prompt = ((story * 30) if n > 1024 else (words * 20))[:n - 1]
            body = {"prompt": prompt, "max_tokens": 32, **greedy}
            unary = _http_json(port, "POST", "/chat", body)
            tokens = unary[2]["data"]["tokens"] if unary[0] == 201 else []
            chat_sse = _sse_call(port, "/chat", {**body, "stream": True})
            frames = [e for _, e in chat_sse["events"]
                      if isinstance(e, dict) and "token" in e]
            comp = _sse_call(port, "/v1/completions",
                             {**body, "stream": True})
            faults = ([] if unary[0] == 201 else ["chat_201"]) \
                + _frame_faults(tokens, frames, tok.decode) \
                + _delta_faults(tokens, comp, tok.decode, 32)
            if not (chat_sse["terminal"] and chat_sse["events"]
                    and chat_sse["events"][-1][1] == "[DONE]"):
                faults.append("chat_stream_done")
            skipped = dict(comp, events=comp["events"][:3]
                           + comp["events"][4:])
            judge(f"a_{n}", faults,
                  _frame_faults(tokens, frames[:5] + frames[6:], tok.decode)
                  + _delta_faults(tokens, skipped, tok.decode, 32))
            texts[n] = (prompt, tok.decode(tokens))
            rows.append({"prompt_tokens": len(tok.encode(prompt)),
                         "tokens": len(tokens), "frames": len(frames),
                         "completion_events": len(comp["events"])})
        out["a"] = rows

        # (b) a concurrent wave of chat streams, then the same as /chat
        lengths = (21, 151, 401, 901)

        def wave(kind):
            got = [None] * len(lengths)
            made.clear()
            stats0 = dict(engine.stats)

            def one(i):
                if kind == "stream":
                    # "user: " + content + "\nassistant:" and bos
                    got[i] = _sse_call(port, "/v1/chat/completions", {
                        "messages": [{"role": "user", "content":
                                      (words * 20)[:lengths[i] - 18]}],
                        "max_tokens": 32, "stream": True, **greedy})
                else:
                    got[i] = _http_json(port, "POST", "/chat", {
                        "prompt": (words * 20)[:lengths[i] - 1],
                        "max_tokens": 32, **greedy})

            workers = [threading.Thread(target=one, args=(i,))
                       for i in range(len(lengths))]
            t0 = time.perf_counter()
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            wall = time.perf_counter() - t0
            tps = ((engine.stats["decode_tokens"] - stats0["decode_tokens"])
                   / (engine.stats["decode_s"] - stats0["decode_s"]))
            return got, {len(r.prompt_tokens): r for r in made}, wall, tps

        streams, by_len, stream_wall, stream_tps = wave("stream")
        unaries, _, unary_wall, unary_tps = wave("unary")
        faults, gaps, client_ttft = [], [], []
        for sse in streams:
            faults += _form_faults(sse, chat=True)
            times = [t for t, e in sse["events"] if _content(e) is not None]
            gaps += [b - a for a, b in zip(times, times[1:])]
            client_ttft.append(times[0] * 1e3 if times else None)
        engine_ttft = [by_len[n].ttft_ms if n in by_len else None
                       for n in lengths]
        # the client's TTFT = the request's way in (connection, parse,
        # tokenize, submit) + the engine's TTFT + the token's way out
        way_in = [(by_len[n].submitted_at - sse["sent_at"]) * 1e3
                  if n in by_len else None
                  for n, sse in zip(lengths, streams)]
        if sorted(by_len) != list(lengths):
            faults.append("prompt_lengths")
        if any(u[0] != 201 for u in unaries):
            faults.append("unary_201")
        cut = dict(streams[0], terminal=False,
                   events=streams[0]["events"][:-1])
        judge("b_well_formed", faults, _form_faults(cut, chat=True))
        out["b"] = {
            "client_ttft_ms": client_ttft, "engine_ttft_ms": engine_ttft,
            "client_minus_engine_ttft_ms": [
                c - e if c is not None and e is not None else None
                for c, e in zip(client_ttft, engine_ttft)],
            "way_in_ms": way_in,
            "gap_ms_p50": float(np.percentile(gaps, 50)) * 1e3,
            "gap_ms_p99": float(np.percentile(gaps, 99)) * 1e3,
            "gap_ms_max": max(gaps) * 1e3, "gaps": len(gaps),
            "stream_wall_s": stream_wall, "unary_wall_s": unary_wall,
            "stream_decode_tokens_per_s": stream_tps,
            "unary_decode_tokens_per_s": unary_tps,
            "stream_over_unary": stream_tps / unary_tps}

        # (c) a stop sequence that first occurs in one of (a)'s texts
        # past its 10th character (the 401-token one first)
        prompt, full, k = next(
            ((prompt, full, k) for prompt, full in (
                texts[401], texts[21], texts[1801])
             for k in range(10, 29) if full.find(full[k:k + 3]) == k),
            (None, None, None))
        if k is None:
            raise AssertionError(f"serve_stream: no 3-character piece of "
                                 f"(a)'s texts first occurs past the 10th "
                                 f"character: {texts}")
        stop = full[k:k + 3]
        answer = _http_json(port, "POST", "/v1/completions", {
            "prompt": prompt, "max_tokens": 32, "stop": stop, **greedy})
        samples = _watch_slots(engine, 0.5, time.perf_counter())
        carried = (answer[0], answer[1], {**answer[2], "choices": [
            {**answer[2]["choices"][0], "text": full}]}) \
            if answer[0] == 201 else answer
        judge("c_stop", _stop_faults(answer, full, stop, 32)
              + _freed_faults(samples, 0.5),
              _stop_faults(carried, full, stop, 32)
              + _freed_faults([(0.5, 1)], 0.5))
        out["c"] = {"stop": stop, "stop_at_char": k,
                    "prompt_tokens": len(tok.encode(prompt)),
                    "completion_tokens": (answer[2].get("usage") or {}).get(
                        "completion_tokens"),
                    "slots_free_after_s": samples[-1][0]}

        # (d) a client that leaves mid-stream, one that leaves queued
        made.clear()
        sse = _sse_call(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "tell a long story"}],
            "max_tokens": 1024, "stream": True, **greedy}, close_after=3)
        req = made[0]
        at_close = len(req.generated)
        samples = _watch_slots(engine, 2.0, sse["closed_at"])
        faults = _freed_faults(samples, 2.0)
        if not req.cancelled or len(req.generated) >= 128:
            faults.append("cancelled_far_below_1024")
        judge("d_mid_stream", faults, _freed_faults([(2.0, 1)], 2.0))
        out["d"] = {"tokens_when_client_closed": at_close,
                    "tokens_final": len(req.generated),
                    "decoded_after_third_event": len(req.generated) - 3,
                    "slots_free_after_s": samples[-1][0]}
        blockers = fill_slots(engine, 1024)
        made.clear()
        sock = _open_post(port, "/chat", {"prompt": "queued",
                                          "max_tokens": 8, "stream": True})
        deadline = time.time() + 60
        while time.time() < deadline and not made:
            time.sleep(0.002)
        queued = made[0]
        sock.close()
        closed = time.perf_counter()
        while time.perf_counter() - closed < 2.0 and not queued.cancelled:
            time.sleep(0.002)
        cancel_s = time.perf_counter() - closed
        busy = sum(b.finished_at is None for b in blockers)
        for b in blockers:
            engine.cancel(b)
        queued.done.wait(60)

        class _Slotted:              # the same request, given a slot
            cancelled, slot, generated, admit_order = True, 0, [7], 0

        judge("d_queued", _queued_faults(queued, cancel_s)
              + ([] if busy == len(blockers) else ["slots_busy_meanwhile"]),
              _queued_faults(_Slotted, cancel_s))
        out["d"].update(queued_cancelled_after_s=cancel_s,
                        blockers_busy_at_check=busy)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    del engine, made
    gc.collect()

    # (e) typed refusals on an engine with max_waiting=1
    engine = llama_engine(params, cfg, serve_config(
        cfg, prefix_cache=False, max_waiting=1), device=dev)
    server, thread, port, _ = serving(engine)
    engine.start()
    try:
        blockers = fill_slots(engine, 1024)
        held = {}
        waiter = threading.Thread(target=lambda: held.update(
            answer=_http_json(port, "POST", "/chat", {
                "prompt": "waits", "max_tokens": 4, **greedy})))
        waiter.start()
        deadline = time.time() + 60
        while time.time() < deadline and engine.waiting.qsize() < 1:
            time.sleep(0.002)
        full_q = _http_json(port, "POST", "/v1/completions", {
            "prompt": "refused", "max_tokens": 4, **greedy})
        for b in blockers:
            engine.cancel(b)
        waiter.join(timeout=60)
        engine.waiting.reconfigure(SchedulerConfig(
            rate_limits={"*": RateLimit(rps=0.5)}))
        body = {"prompt": "rapid", "max_tokens": 4, **greedy}
        first = _http_json(port, "POST", "/v1/completions", body)
        second = _http_json(port, "POST", "/v1/completions", body)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    faults = _refusal_faults(full_q, 503, "server_error")
    if held.get("answer", (0,))[0] != 201:
        faults.append("waiter_201")
    judge("e_queue_full", faults,
          _refusal_faults(held.get("answer", (201, {}, {})), 503,
                          "server_error"))
    judge("e_rate_limited",
          _refusal_faults(second, 429, "rate_limit_error")
          + ([] if first[0] == 201 else ["first_201"]),
          _refusal_faults((429, {}, second[2]), 429, "rate_limit_error"))
    out["e"] = {"queue_full": [full_q[0], full_q[1].get("retry-after"),
                               full_q[2].get("error")],
                "rate_limited": [second[0], second[1].get("retry-after"),
                                 second[2].get("error")]}
    del engine
    gc.collect()

    # (f) starvation preemption, on and off
    rng = np.random.default_rng(8)
    bg_prompts = [rng.integers(0, cfg.vocab_size, 301).tolist()
                  for _ in range(8)]
    fg_prompt = rng.integers(0, cfg.vocab_size, 21).tolist()

    def starve(starvation_s):
        engine = llama_engine(params, cfg, serve_config(
            cfg, scheduler=SchedulerConfig(starvation_s=starvation_s)),
            device=dev)
        bg = [engine.submit(p, SamplingParams(temperature=0.0,
                                              max_new_tokens=1536),
                            lane="background") for p in bg_prompts]
        engine.start()
        try:
            deadline = time.time() + 120
            while time.time() < deadline and not all(r.generated for r in bg):
                time.sleep(0.002)
            fg = engine.submit(fg_prompt, SamplingParams(
                temperature=0.0, max_new_tokens=32))
            reqs = bg + [fg]
            while time.time() < deadline and not all(
                    r.done.is_set() for r in reqs):
                time.sleep(0.01)
        finally:
            engine.stop()
        run = {"starvation_s": starvation_s,
               "scheduler_preemptions": engine.waiting.counters[
                   "preemptions"],
               "engine_preemptions": engine.stats["preemptions"],
               "interactive_ttft_ms": fg.ttft_ms,
               "victims": [i for i, r in enumerate(reqs) if r.folded],
               "folded": [r.folded for r in reqs],
               "errors": [r.error for r in reqs if r.error],
               "n_tokens": [len(r.generated) for r in reqs],
               "tokens": [list(r.generated) for r in reqs],
               "decode_tokens_per_s": engine.stats["decode_tokens"]
               / engine.stats["decode_s"]}
        del engine
        gc.collect()
        return run

    calm = starve(0.0)
    run = starve(0.25)
    victim = (run["victims"] or [0])[0]
    bent = dict(run, tokens=[list(t) for t in run["tokens"]])
    bent["tokens"][victim][max(0, run["folded"][victim] - 1)] += 1
    judge("f_starvation", _starve_faults(run, calm)
          + (["calm_run_preempted"] if calm["engine_preemptions"] else []),
          _starve_faults(bent, calm))
    n = run["folded"][victim]
    out["f"] = {k: [run[k], calm[k]] for k in (
        "scheduler_preemptions", "engine_preemptions",
        "interactive_ttft_ms", "victims", "n_tokens",
        "decode_tokens_per_s")}
    out["f"]["victim_tokens_at_preemption"] = n
    out["f"]["victim_tokens_equal_after_preemption"] = \
        run["tokens"][victim][n:] == calm["tokens"][victim][n:]
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # (g) the kernels this phase launched
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    judge("g_launches", _counter_faults(launches),
          _counter_faults({**launches, "paged_chunk_attention": 0}))
    out.update(launches=launches, failed_checks=failed,
               planted={k: v for k, v in planted.items()},
               seconds=time.perf_counter() - t_phase)
    emit(out)
    bad = {k: v for k, v in failed.items() if v}
    if bad:
        raise AssertionError(f"serve_stream: checks failed: {bad}")
    missed = [k for k, v in planted.items() if not v]
    if missed:
        raise AssertionError(f"serve_stream: planted faults passed every "
                             f"check: {missed}")


#: every series ``gofr_tpu/serving/engine.py:attach_metrics`` registers
#: (the port names ``app_tpu_execute_seconds`` ``app_gpu_execute_seconds``;
#: ``tests/test_torch_obs_engine.py`` holds the port's app to the JAX
#: engine's own registration on the CPU)
JAX_ENGINE_METRICS = (
    "app_chat_e2e_seconds", "app_chat_queue_seconds",
    "app_chat_tpot_seconds", "app_chat_ttft_seconds",
    "app_engine_active_slots", "app_engine_batch_occupancy",
    "app_engine_cost_drift", "app_engine_goodput_ratio",
    "app_engine_h2d_transfers", "app_engine_host_rss_bytes_watermark",
    "app_engine_integrity_failures", "app_engine_kv_bytes_watermark",
    "app_engine_kv_pages_watermark", "app_engine_kv_pool_fragmentation",
    "app_engine_kv_pool_utilization", "app_engine_kv_rows_watermark",
    "app_engine_mfu", "app_engine_preemptions",
    "app_engine_prefix_cache_entries", "app_engine_prefix_cache_pages",
    "app_engine_prefix_evictions", "app_engine_prefix_pages_watermark",
    "app_engine_recompiles", "app_engine_requests_recovered",
    "app_engine_requeues", "app_engine_restarts",
    "app_engine_spec_accept_rate", "app_engine_spec_accepted",
    "app_engine_spec_drafted", "app_engine_stalls",
    "app_engine_tokens_per_second", "app_engine_waiting",
    "app_engine_waste_seconds", "app_events_dropped", "app_events_total",
    "app_replay_divergence", "app_sched_lane_depth", "app_sched_preemptions",
    "app_sched_rejections", "app_sched_shed_active", "app_sched_tenant_share",
    "app_slo_burn_rate", "app_slo_error_budget_remaining",
    "app_tenant_completion_tokens", "app_tenant_device_seconds",
    "app_tenant_e2e_seconds", "app_tenant_prompt_tokens",
    "app_tenant_queue_seconds", "app_tenant_requests",
    "app_tenant_waste_seconds", "app_tpu_execute_seconds")
#: the planes off: no recorder, goodput, sentinel, costs, digests,
#: events, watchdog
PLANES_OFF = dict(flight_recorder_size=0, goodput=False,
                  recompile_sentinel=False, cost_model=False,
                  integrity=False, events=False, watchdog_interval_s=0,
                  stall_threshold_s=0)


def _digest_faults(got: dict, want: dict) -> list:
    """Prompts whose digest differs between two runs, or is missing."""
    if set(got) != set(want):
        return ["prompt_sets_differ"]
    return [f"digest_{len(p)}" for p in want if got[p] != want[p]]


def _counter_match_faults(a: dict, b: dict) -> list:
    return [f"{k}: {a[k]} != {b[k]}" for k in a if a[k] != b[k]]


def _goodput_faults(state: dict, passes: list, max_batch: int) -> list:
    """Conservation to 1e-9 relative, padding as the pass records imply
    (empty decode rows over max_batch, a group's dummy rows over its
    size, times the pass's recorded busy seconds), a bubble."""
    faults = []
    busy, useful, waste = state["busy_s"], state["useful_s"], state["waste_s"]
    if abs(useful + sum(waste.values()) - busy) > 1e-9 * busy:
        faults.append("conservation")
    padding = 0.0
    for rec in passes:
        if rec["kind"] == "decode":
            padding += (max_batch - rec["occupancy"]) / max_batch * rec["dur"]
        elif rec["kind"] in ("prefill", "prefill_chunk"):
            group = int(rec["sig"].split("/")[2])
            padding += (group - rec["rows"]) / group * rec["dur"]
    if abs(padding - waste["padding"]) > 1e-6 * max(1, len(passes)):
        faults.append(f"padding {waste['padding']} != {padding}")
    if not waste["bubble"] > 0:
        faults.append("no_bubble")
    return faults


def _probe_faults(run: dict) -> list:
    """At least 4 probes, none mismatched, their time re-priced."""
    faults = []
    probes, integ = run["integrity"]["probes"], run["integrity"]
    if probes["run"] < 4:
        faults.append(f"probes_run {probes['run']}")
    if probes["mismatch"] or integ["episodes"]:
        faults.append(f"mismatch {probes['mismatch']}")
    # a probe's device time leaves useful, at most all of it (the meter
    # moves no more than useful holds)
    waste = run["goodput_raw"]["waste_s"]["integrity_probe"]
    if not 0 < waste <= integ["probe_device_s"] + 1e-6:
        faults.append(f"repriced {waste} vs {integ['probe_device_s']}")
    return faults


def _episode_faults(run: dict, users: dict) -> list:
    """Exactly one mismatch episode: one warn ``obs.integrity`` event,
    the failure counter at 1, the user requests' digests unchanged."""
    faults = []
    if run["integrity"]["episodes"] != 1:
        faults.append(f"episodes {run['integrity']['episodes']}")
    if run["integrity_warns"] != 1:
        faults.append(f"warn_events {run['integrity_warns']}")
    if run["integrity_failures_metric"] != 1:
        faults.append(f"counter {run['integrity_failures_metric']}")
    return faults + _digest_faults(run["digests"], users)


def _drift_faults(run: dict) -> list:
    """One drift episode on ``decode/0``: one ``obs.cost_drift`` event,
    ``app_engine_cost_drift{kind="decode"}`` at 1, none elsewhere."""
    faults = []
    sig = run["costs"]["signatures"].get("decode/0", {})
    if sig.get("drift_episodes") != 1 or run["costs"]["drift_episodes"] != 1:
        faults.append(f"episodes {run['costs']['drift_episodes']}")
    if run["drift_events"] != 1:
        faults.append(f"events {run['drift_events']}")
    if run["drift_metric"] != 1:
        faults.append(f"counter {run['drift_metric']}")
    return faults


def _stall_faults(samples: list, run: dict) -> list:
    """DEGRADED (HTTP 200, with ``stalled_for_s``) during the stall, one
    watchdog episode (``fleet.stall`` event, ``app_engine_stalls`` 1),
    UP after it."""
    faults = []
    degraded = [s for s in samples if s[1] == "DEGRADED"]
    if not degraded or not all(s[0] == 200 and s[2] for s in degraded):
        faults.append("no_degraded")
    if run["stall_events"] != 1 or run["stalls_metric"] != 1:
        faults.append(f"stalls {run['stall_events']}/{run['stalls_metric']}")
    if run["health_after"] != "UP":
        faults.append(f"after {run['health_after']}")
    return faults


def _up_faults(samples: list) -> list:
    bad = sorted({s[1] for s in samples if s[1] != "UP"})
    return [f"health {bad}"] if bad or not samples else []


def _metrics_faults(text: str, names, e2e: int, mfu: tuple,
                    basis: tuple) -> list:
    """Every JAX engine series (under the rename) on ``/metrics``,
    ``app_chat_e2e_seconds_count`` = the served requests, and an MFU
    sample > 0 that equals tokens/s x flops per token / peak (the
    gauges' rounding: tokens/s to 0.01, MFU to 1e-6)."""
    faults = []
    helped = {ln.split()[2] for ln in text.splitlines()
              if ln.startswith("# HELP ")}
    want = {("app_gpu_execute_seconds" if n == "app_tpu_execute_seconds"
             else n) for n in names}
    if want - helped:
        faults.append(f"missing {sorted(want - helped)}")
    counts = [ln for ln in text.splitlines()
              if ln.startswith("app_chat_e2e_seconds_count")]
    if counts != [f"app_chat_e2e_seconds_count {e2e}"]:
        faults.append(f"e2e {counts}")
    value, tps = mfu
    flops, peak = basis
    if not value > 0 or abs(value - tps * flops / peak) > \
            0.005 * flops / peak + 1e-6:
        faults.append(f"mfu {value} vs {tps} x {flops} / {peak}")
    return faults


def phase_serve_obs(dev, smi_line: str, cfg=None) -> None:
    """The accounting and integrity planes on the card, through the
    port's app on ``cfg`` (default ``llama3_1b``; random weights, seed
    0) and ``serve_config``, greedy, over ``serve``'s three waves
    (``POST /chat``). Every engine is warmed up first (the decode graphs
    captured, the recompile sentinel sealed, the MFU basis fixed) and
    admits each wave as one batch: its pops wait until the whole wave
    is queued, so two runs batch alike.

    (a) two engines in one process, the planes off (no recorder,
        goodput, sentinel, cost model, digests, events, watchdog,
        metrics or SLO) and on (``build_server``: all of them): every
        request's digest equal (the off run's from ``request_digest``,
        the on run's stamped by the engine), and equal
        ``sched_syncs``, ``h2d_transfers``, ``graph_captures`` and
        launches per kernel; decode tokens/s of both (recorded).
        Planted: one token of one request changed.
    (b) the on run's goodput: useful + waste = busy to 1e-9 relative,
        padding as the recorder's passes imply, a bubble (depth 0 at
        four slots, work waiting). Planted: the padding seconds dropped.
    (c) a golden set sealed in a temp dir from 4 greedy prompts (33-60
        tokens, one page: no prefix entry) served alone on the planes-off
        engine; the waves again with probes every 4 collected passes
        until 4 ran: none mismatches, their device time re-priced to
        ``integrity_probe``. The same with ``logit_corrupt`` on the
        probes' tenant: exactly one episode (one warn ``obs.integrity``
        event, ``app_engine_integrity_failures{kind="probe_mismatch"}``
        1), the user requests' digests those of (a). Each check is shown
        the other run.
    (d) the same runs with ``cost_baseline_passes=4``; the faulted one
        also skews ``decode/0``'s 8th observation by 1 s: exactly one
        drift episode, one ``obs.cost_drift`` event,
        ``app_engine_cost_drift{kind="decode"}`` 1; the clean one must
        fail that check. The on run's ``GET /debug/costs`` lists every
        signature its passes recorded (decode, prefill, chunk), and (e)'s
        speculative run's lists its verify signatures.
    (e) a speculative engine (``spec_ngram=2``, fixed depth) with
        ``pass_stall:seconds=2``, ``stall_threshold_s=0.5``,
        ``watchdog_interval_s=0.1``, two requests queued before
        ``start()``: ``/.well-known/health`` answers 200 DEGRADED with
        ``stalled_for_s``, one ``fleet.stall`` event (the JAX engine's
        kind; the ``engine.stall`` span goes to the server's tracer,
        checked on the CPU in ``tests/test_torch_tracing.py``),
        ``app_engine_stalls`` 1, UP after the stall; the on
        run of (a) stays UP throughout. Each check is shown the other
        run's samples.
    (f) the on run's ``/metrics`` (its own server): every series the
        JAX engine registers, ``app_chat_e2e_seconds_count`` = the
        requests served, and ``app_engine_mfu`` > 0 equal to
        ``app_engine_tokens_per_second`` x flops per token / peak
        (sampled while serving). Planted: a name the port does not
        serve, one request more, twice the peak. Recorded: the decode
        dispatch's MFU on device time, the useful tokens' flops (4 rows
        x T steps) over its CUDA-event ms x peak."""
    import tempfile

    import torch
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_decode_flops,
                                             llama_init)
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import (kv_write, rope_kv_write,
                                             scatter_chunk_kv)
    from gofr_tpu_torch.serving.app import (ChatServer, build_metrics_server,
                                            build_server, serve_config)
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.handlers import make_chat_handler
    from gofr_tpu_torch.serving.integrity import GoldenSet, request_digest
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    cfg = cfg or LlamaConfig.llama3_1b()
    t_phase = time.perf_counter()
    counters = {"flash_attention": (flash_attention, "launches"),
                "paged_decode_attention": (paged_decode_attention,
                                           "launches"),
                "paged_chunk_attention": (paged_chunk_attention, "launches"),
                "rope_kv_write": (rope_kv_write, "launches"),
                "scatter_chunk_kv": (scatter_chunk_kv, "launches"),
                "kv_write": (kv_write, "launches")}
    tok = ByteTokenizer()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    failed: dict = {}
    planted: dict = {}
    out: dict = {"phase": "serve_obs", "card": smi_line}
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")
    long_prompt = (story * 30)[:1800]
    waves = [[(words * 20)[:n] for n in (20, 150, 400, 900)], [long_prompt],
             [(words * 20)[:900] + " but the question at the end is new",
              (words * 20)[:400] + " and this ending differs",
              long_prompt[:1795] + " until a new ending"]]
    n_requests = sum(len(w) for w in waves)
    golden_prompts = [[(37 * i + 11 * n) % cfg.vocab_size for i in range(n)]
                      for n in (33, 40, 48, 60)]
    golden_params = SamplingParams(temperature=0.0, max_new_tokens=16)

    def judge(name, faults, planted_faults):
        failed[name], planted[name] = faults, planted_faults

    def make(**kw):
        engine = llama_engine(params, cfg, serve_config(cfg, **kw),
                              device=dev)
        if not kw.get("speculative"):
            engine.warmup(prompt_lens=(20, 60, 150, 400, 900),
                          chunked=True)
        return engine

    def serve(engine, planes: bool, until=None, queued_before=0):
        """The app over ``engine``; the waves through ``POST /chat``,
        each admitted as one batch; then ``until(engine)``. Returns the
        run's record."""
        if planes:
            server = build_server(engine, tok, port=0, name="llama3_1b")
            metrics_server = build_metrics_server(server.metrics, port=0)
        else:
            server = ChatServer(("127.0.0.1", 0), engine)
            server.post("/chat", make_chat_handler(engine, tok))
            metrics_server = None
        made, inner = [], engine.submit
        gate = {"need": 0, "made": 0}

        def submit(prompt, *args, **kwargs):
            req = inner(prompt, *args, **kwargs)
            made.append((list(prompt), req))
            return req

        inner_pop = engine._pop_waiting

        def pop(n, wait_s):
            # never blocks inside the queue: a pop waiting there would
            # take a wave's first request alone
            if len(made) - gate["made"] >= gate["need"]:
                popped = inner_pop(n, 0.0)
                if popped:
                    return popped
            time.sleep(0.001)
            return []

        engine.submit, engine._pop_waiting = submit, pop
        servers = [s for s in (server, metrics_server) if s is not None]
        threads = [threading.Thread(target=s.serve_forever, daemon=True)
                   for s in servers]
        for t in threads:
            t.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        samples, mfu_samples, stop_sampling = [], [], threading.Event()

        def sample():
            gauges = server.metrics if planes else None
            while not stop_sampling.wait(0.01):
                samples.append((200, engine.health_check()["status"], None))
                if gauges is not None:
                    # tokens/s is set before MFU: a pair read between two
                    # equal tokens/s reads belongs to one update
                    tps = gauges.get("app_engine_tokens_per_second").get()
                    mfu = gauges.get("app_engine_mfu").get()
                    if tps == gauges.get(
                            "app_engine_tokens_per_second").get():
                        mfu_samples.append((mfu, tps))

        sampler = threading.Thread(target=sample, daemon=True)
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        stats0 = dict(engine.stats)
        engine.start()
        sampler.start()
        answers = []
        try:
            for wave in waves:
                gate["need"], gate["made"] = len(wave), len(made)
                got: list = [None] * len(wave)

                def ask(prompt, i):
                    got[i] = _http_json(server.server_address[1], "POST",
                                        "/chat", {"prompt": prompt,
                                                  "max_tokens": 32,
                                                  "temperature": 0})[::2]

                workers = [threading.Thread(target=ask, args=(p, i))
                           for i, p in enumerate(wave)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=600)
                answers += got
            # probes tick on collected passes: an idle engine runs none,
            # so a filler request (not a user's: its digest is not
            # compared) keeps passes coming until ``until`` holds
            deadline = time.time() + 60
            while until is not None and not until(engine) \
                    and time.time() < deadline:
                if engine.integrity.inflight:
                    time.sleep(0.01)         # a probe runs its own passes
                    continue
                inner(tok.encode(waves[0][0]),
                      SamplingParams(temperature=0.0,
                                     max_new_tokens=32)).done.wait(30)
            stop_sampling.set()
            sampler.join(timeout=10)
            launches = {name: getattr(fn, attr)
                        for name, (fn, attr) in counters.items()}
            record = {"answers": answers, "samples": samples,
                      "mfu_samples": mfu_samples, "launches": launches,
                      "stats": {k: engine.stats[k] - stats0.get(k, 0)
                                if isinstance(engine.stats[k], (int, float))
                                else engine.stats[k] for k in engine.stats}}
            if planes:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:"
                        f"{metrics_server.server_address[1]}/metrics",
                        timeout=30) as resp:
                    record["metrics_text"] = resp.read().decode()
                with urllib.request.urlopen(url + "/debug/costs",
                                            timeout=30) as resp:
                    record["debug_costs"] = json.loads(
                        resp.read())["data"]["llama3_1b"]
                metrics = server.metrics
                record.update(
                    integrity_failures_metric=metrics.get(
                        "app_engine_integrity_failures").get(
                            kind="probe_mismatch"),
                    drift_metric=metrics.get("app_engine_cost_drift").get(
                        kind="decode"))
        finally:
            stop_sampling.set()
            for s in servers:
                s.shutdown()
                s.server_close()
            engine.stop()
            engine.submit, engine._pop_waiting = inner, inner_pop
        users = [(p, r) for p, r in made if not r.probe]
        record["digests"] = {
            tuple(p): (r.digest if planes else request_digest(
                r.prompt_tokens, r.params, r.generated)) for p, r in users}
        record["requests"] = users
        s = record["stats"]
        record["decode_tokens_per_s"] = s["decode_tokens"] / s["decode_s"]
        if planes:
            events = engine.events.snapshot()
            gp = engine.goodput
            record.update(
                goodput=engine.goodput.state(),
                goodput_raw={"busy_s": gp.busy_s, "useful_s": gp.useful_s,
                             "waste_s": dict(gp.waste_s)},
                passes=engine.recorder.snapshot()["passes"],
                integrity=engine.integrity.state(),
                costs=engine.costs.state(),
                integrity_warns=sum(e["kind"] == "obs.integrity"
                                    and e["severity"] == "warn"
                                    for e in events),
                drift_events=sum(e["kind"] == "obs.cost_drift"
                                 for e in events))
        if any(a is None or a[0] != 201 for a in answers):
            raise AssertionError(f"serve_obs: not every answer was 201: "
                                 f"{answers}")
        return record

    # (a) the planes off, then on; the golden set sealed on the off engine
    engine = make(**PLANES_OFF)
    off = serve(engine, planes=False)
    golden = []
    engine.waiting.reopen()
    engine.start()
    try:
        for prompt in golden_prompts:
            req = engine.submit(prompt, golden_params)
            req.done.wait(60)
            golden.append({"prompt_tokens": prompt, "digest": request_digest(
                req.prompt_tokens, req.params, req.generated),
                "params": {"temperature": 0.0, "top_p": 1.0, "top_k": 0,
                           "max_new_tokens": 16}})
    finally:
        engine.stop()
    # the decode dispatch's MFU on device time, wave 1's prompts
    engine.waiting.reopen()
    dispatch = _dispatch_device_ms(engine, [tok.encode(p) for p in waves[0]])
    tmp = tempfile.mkdtemp(prefix="gofr_golden_")
    golden_path = str(Path(tmp) / "golden.jsonl")
    GoldenSet.seal(golden).save(golden_path)
    del engine
    gc.collect()
    engine = make()
    on = serve(engine, planes=True)
    flops = engine._flops_per_token
    peak = engine._peak_flops
    del engine
    gc.collect()
    keys = ("sched_syncs", "h2d_transfers", "graph_captures")
    first_prompt, first = on["requests"][0]
    bent = dict(on["digests"])
    bent[tuple(first_prompt)] = request_digest(
        first.prompt_tokens, first.params,
        first.generated[:-1] + [first.generated[-1] ^ 1])
    judge("a_digests", _digest_faults(on["digests"], off["digests"]),
          _digest_faults(bent, off["digests"]))
    judge("a_counters",
          _counter_match_faults({k: on["stats"][k] for k in keys},
                                {k: off["stats"][k] for k in keys})
          + _counter_match_faults(on["launches"], off["launches"]),
          _counter_match_faults(
              {**on["launches"],
               "rope_kv_write": on["launches"]["rope_kv_write"] + 16},
              off["launches"]))
    out["a"] = {"decode_tokens_per_s_planes_off":
                off["decode_tokens_per_s"],
                "decode_tokens_per_s_planes_on": on["decode_tokens_per_s"],
                "ratio": on["decode_tokens_per_s"]
                / off["decode_tokens_per_s"],
                "counters_off": {k: off["stats"][k] for k in keys},
                "counters_on": {k: on["stats"][k] for k in keys},
                "launches": on["launches"],
                "recompiles": on["stats"]["recompiles"]}

    # (b) goodput conservation and padding
    raw = on["goodput_raw"]
    dropped = dict(raw, waste_s={**raw["waste_s"], "padding": 0.0})
    judge("b_goodput", _goodput_faults(raw, on["passes"], 8),
          _goodput_faults(dropped, on["passes"], 8))
    out["b"] = {"goodput": {k: on["goodput"][k] for k in (
        "busy_s", "useful_s", "waste_s", "goodput_ratio", "passes")},
        "passes_recorded": len(on["passes"])}

    # (c) + (d): probes and drift, clean and faulted
    def probed(faults=None):
        engine = make(integrity_golden_path=golden_path,
                      integrity_probe_passes=4, cost_baseline_passes=4,
                      faults=faults)
        try:
            return serve(engine, planes=True, until=lambda e:
                         e.integrity.probes["run"] >= 4
                         and not e.integrity.inflight)
        finally:
            del engine
            gc.collect()

    clean = probed()
    faulty = probed("logit_corrupt:request=_integrity;"
                    "cost_skew:request=decode/0,at=8,seconds=1.0")
    judge("c_probes", _probe_faults(clean), _probe_faults(faulty))
    judge("c_episode", _episode_faults(faulty, on["digests"]),
          _episode_faults(clean, on["digests"]))
    judge("c_users_unchanged", _digest_faults(clean["digests"],
                                              on["digests"]),
          _digest_faults(clean["digests"],
                         {**on["digests"], tuple(first_prompt): "0" * 32}))
    judge("d_drift", _drift_faults(faulty), _drift_faults(clean))
    recorded = {rec["sig"] for rec in on["passes"]}
    listed = set(on["debug_costs"]["costs"]["signatures"])
    kinds = {sig.split("/")[0] for sig in listed}

    def cost_listing_faults(listed, kinds):
        return ([f"unlisted {sorted(recorded - listed)}"]
                if recorded - listed else []) + \
            ([f"kinds {sorted(kinds)}"]
             if not {"decode", "prefill", "chunk"} <= kinds else [])

    judge("d_debug_costs", cost_listing_faults(listed, kinds),
          cost_listing_faults(listed - {"decode/0"}, kinds - {"chunk"}))
    out["c"] = {k: {"probes": r["integrity"]["probes"],
                    "episodes": r["integrity"]["episodes"],
                    "probe_device_s": r["integrity"]["probe_device_s"],
                    "integrity_probe_waste_s":
                    r["goodput"]["waste_s"]["integrity_probe"],
                    "integrity_warn_events": r["integrity_warns"]}
                for k, r in (("clean", clean), ("faulted", faulty))}
    out["d"] = {k: {"drift_episodes": r["costs"]["drift_episodes"],
                    "decode_baseline_s": r["costs"]["signatures"].get(
                        "decode/0", {}).get("baseline_s"),
                    "drift_events": r["drift_events"]}
                for k, r in (("clean", clean), ("faulted", faulty))}
    out["d"]["signatures_listed"] = sorted(listed)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # (e) the stall watchdog, on a speculative engine
    engine = make(speculative=True, spec_ngram=2, spec_adaptive=False,
                  faults="pass_stall:seconds=2", stall_threshold_s=0.5,
                  watchdog_interval_s=0.1)
    server = build_server(engine, tok, port=0, name="llama3_1b")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stall_answers: list = [None, None]

    def ask_stalled(i):
        stall_answers[i] = _post(base + "/chat", {
            "prompt": (words * 6)[:300 + 50 * i], "max_tokens": 48,
            "temperature": 0})

    workers = [threading.Thread(target=ask_stalled, args=(i,))
               for i in range(2)]
    stall_samples = []
    try:
        for w in workers:
            w.start()
        deadline = time.time() + 30
        while engine.waiting.qsize() < 2 and time.time() < deadline:
            time.sleep(0.005)
        engine.start()
        deadline = time.time() + 3.0
        while time.time() < deadline:
            status, body = _http_json(server.server_address[1], "GET",
                                      "/.well-known/health")[::2]
            stall_samples.append((status, body["data"]["status"],
                                  body["data"].get("stalled_for_s")))
            time.sleep(0.05)
        for w in workers:
            w.join(timeout=120)
        with urllib.request.urlopen(base + "/debug/costs",
                                    timeout=30) as resp:
            spec_sigs = sorted(json.loads(resp.read())["data"]["llama3_1b"]
                               ["costs"]["signatures"])
        stall_run = {
            "stall_events": sum(e["kind"] == "fleet.stall"
                                for e in engine.events.snapshot()),
            "stalls_metric": server.metrics.get("app_engine_stalls").get(),
            "health_after": engine.health_check()["status"]}
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    if any(a is None or a[0] != 201 for a in stall_answers):
        raise AssertionError(f"serve_obs: a stalled request failed: "
                             f"{stall_answers}")
    judge("e_stall", _stall_faults(stall_samples, stall_run),
          _stall_faults(on["samples"], stall_run))
    judge("e_unstalled_up", _up_faults(on["samples"]),
          _up_faults(stall_samples))
    judge("e_verify_listed",
          [] if any(s.startswith("spec_verify/") for s in spec_sigs)
          else ["no_verify_signature"],
          [] if any(s.startswith("spec_verify/") for s in
                    recorded) else ["no_verify_signature"])
    out["e"] = {"degraded_samples": sum(s[1] == "DEGRADED"
                                        for s in stall_samples),
                "max_stalled_for_s": max((s[2] or 0.0)
                                         for s in stall_samples),
                **stall_run, "verify_signatures": [
                    s for s in spec_sigs if s.startswith("spec_verify/")]}
    del engine
    gc.collect()

    # (f) /metrics
    best = max(on["mfu_samples"], default=(0.0, 0.0))
    judge("f_metrics",
          _metrics_faults(on["metrics_text"], JAX_ENGINE_METRICS,
                          n_requests, best, (flops, peak)),
          _metrics_faults(on["metrics_text"], JAX_ENGINE_METRICS
                          + ("app_engine_not_served",), n_requests, best,
                          (flops, peak))
          + _metrics_faults(on["metrics_text"], JAX_ENGINE_METRICS,
                            n_requests + 1, best, (flops, peak))
          + _metrics_faults(on["metrics_text"], JAX_ENGINE_METRICS,
                            n_requests, best, (flops, 2 * peak)))
    steps = dispatch["steps_per_dispatch"]
    out["f"] = {"mfu": best[0], "tokens_per_s": best[1],
                "flops_per_token": flops, "peak_flops": peak,
                "dispatch_ms": dispatch["ms"],
                "dispatch_device_mfu": len(waves[0]) * steps * flops
                / (dispatch["ms"] / 1e3 * peak) if peak else None}
    out.update(failed_checks=failed, planted=planted,
               seconds=time.perf_counter() - t_phase)
    emit(out)
    bad = {k: v for k, v in failed.items() if v}
    if bad:
        raise AssertionError(f"serve_obs: checks failed: {bad}")
    missed = [k for k, v in planted.items() if not v]
    if missed:
        raise AssertionError(f"serve_obs: planted faults passed every "
                             f"check: {missed}")


class _GatedApp:
    """One engine behind the port's app (``build_server``) and its
    metrics port. Every request the handlers submit is kept as (prompt
    ids, ``GenRequest``), and the engine's queue pop is gated: it takes
    requests only when the count submitted since ``mark()`` is one of
    the stops (or past the last), so a wave is admitted as one batch, as
    in ``serve_obs``."""

    def __init__(self, engine, tok, env=None, tracer=None) -> None:
        from gofr_tpu_torch.serving.app import (build_metrics_server,
                                                build_server)
        from gofr_tpu_torch.serving.openai_compat import install_openai_routes
        self.engine = engine
        self.server = build_server(engine, tok, port=0, name="llama3_1b",
                                   env=env or {}, tracer=tracer)
        install_openai_routes(self.server, engine, tok, model="llama3_1b")
        self.metrics_server = build_metrics_server(self.server.metrics,
                                                   port=0)
        self.port = self.server.server_address[1]
        self.made: list = []
        self._base, self.stops = 0, {0}
        self._inner_submit, self._inner_pop = engine.submit, engine._pop_waiting

        def submit(prompt, *args, **kwargs):
            req = self._inner_submit(prompt, *args, **kwargs)
            self.made.append((list(prompt), req))
            return req

        def pop(n, wait_s):
            count = len(self.made) - self._base
            if count in self.stops or count > max(self.stops):
                popped = self._inner_pop(n, 0.0)
                if popped:
                    return popped
            time.sleep(0.001)
            return []

        engine.submit, engine._pop_waiting = submit, pop
        self._threads = [threading.Thread(target=s.serve_forever, daemon=True)
                         for s in (self.server, self.metrics_server)]
        for t in self._threads:
            t.start()

    def mark(self, stops) -> None:
        self._base, self.stops = len(self.made), set(stops)

    def ask(self, asks, *, before_start: bool = False) -> list:
        """Send ``asks`` ((path, body, stream) each) at once and return
        their answers in order: ``(status, headers, body)`` for a unary
        one, ``_sse_call``'s record for a stream. With ``before_start``
        every request is queued before the engine starts."""
        self.mark({len(asks)})
        if before_start:
            # a stopped engine refuses submits until start() reopens it
            self.engine.waiting.reopen()
        got: list = [None] * len(asks)

        def call(i, path, body, stream):
            got[i] = (_sse_call(self.port, path, body) if stream
                      else _http_json(self.port, "POST", path, body))

        workers = [threading.Thread(target=call, args=(i, *a))
                   for i, a in enumerate(asks)]
        for w in workers:
            w.start()
        if before_start:
            deadline = time.time() + 60
            while self.engine.waiting.qsize() < len(asks) \
                    and time.time() < deadline:
                time.sleep(0.002)
            self.engine.start()
        for w in workers:
            w.join(timeout=600)
        return got

    def close(self) -> None:
        for s in (self.server, self.metrics_server):
            s.shutdown()
            s.server_close()
        self.engine.stop()
        self.engine.submit, self.engine._pop_waiting = (self._inner_submit,
                                                        self._inner_pop)


def _recovered_faults(run: dict, clean: dict) -> list:
    """(b): every walker recovered and its digest the clean run's, the
    decoder failed typed, one restart (a ring buffer of the decode graph
    left busy by the dispatch in flight would have failed the next
    launch: a second restart), nothing recaptured or reallocated."""
    faults = []
    if run["recovered"] != run["walkers"]:
        faults.append(f"recovered {run['recovered']}")
    if run["restarts_metric"] != 1 or run["recovered_metric"] != \
            run["walkers"]:
        faults.append(f"counters {run['restarts_metric']}/"
                      f"{run['recovered_metric']}")
    faults += _digest_faults(run["digests"], clean["digests"])
    if run["decoder"] != (503, "engine_restart", "1"):
        faults.append(f"decoder {run['decoder']}")
    for key in ("graph_captures", "memory_allocated", "launches_per_replay"):
        if run[key] != clean[key]:
            faults.append(f"{key} {run[key]} != {clean[key]}")
    return faults


def _midstream_faults(answers: list) -> list:
    """(b): unary answers 503 + Retry-After + ``engine_restart``; a
    stream's 200, then the typed error event, no ``[DONE]``."""
    faults = []
    for i, answer in enumerate(answers):
        if isinstance(answer, dict):              # a stream
            events = [e for _, e in answer["events"]]
            last = events[-1] if events else None
            if answer["status"] != 200 or not isinstance(last, dict) \
                    or (last.get("details") or {}).get("code") \
                    != "engine_restart" or "[DONE]" in events:
                faults.append(f"stream_{i}")
        else:
            status, headers, body = answer
            details = (body.get("error") or {}).get("details") or {}
            if status != 503 or headers.get("retry-after") != "1" \
                    or details.get("code") not in ("engine_restart", None) \
                    or (details.get("code") is None
                        and details.get("type") != "server_error"):
                faults.append(f"unary_{i} {status} {details}")
    return faults


def _budget_faults(run: dict) -> list:
    """(c): DOWN, the restarts the budget allowed, a ``restart_budget``
    bundle served at ``?id=``, and the next submit a typed
    ``engine_down`` 503 with ``Retry-After``."""
    faults = []
    if run["health"] != "DOWN":
        faults.append(f"health {run['health']}")
    if run["bundle_reason"] != "restart_budget" or run["bundle_status"] \
            != 200:
        faults.append(f"bundle {run['bundle_status']} "
                      f"{run['bundle_reason']}")
    if run["next"] != (503, "1", "engine_down"):
        faults.append(f"next {run['next']}")
    if run["unknown_id_status"] != 404:
        faults.append(f"unknown id {run['unknown_id_status']}")
    return faults


def _span_faults(run: dict, trace_id: str) -> list:
    """(d): the answer's ``X-Trace-Id`` is the caller's trace, whose
    spans run HTTP -> ``engine.request`` -> queue, prefill, decode,
    retire; the trace id is an exemplar on ``/metrics``."""
    faults = []
    if run["x_trace_id"] != trace_id:
        faults.append(f"x_trace_id {run['x_trace_id']}")
    tree = run["tree"]
    if tree.get("http_parent") != run["inbound_parent"]:
        faults.append("http_parent")
    if not tree.get("request_under_http"):
        faults.append("engine_request_parent")
    children = tree.get("children", [])
    if not children or children[0] != "engine.queue" \
            or children[-2:] != ["engine.decode", "engine.retire"] \
            or "engine.prefill" not in children:
        faults.append(f"children {children}")
    if f'trace_id="{trace_id}"' not in run["openmetrics"]:
        faults.append("no_exemplar")
    return faults


def _replay_faults(report: dict, want_divergent: bool) -> list:
    """(e): a clean replay has 0 divergent requests of all compared; a
    corrupted one at least one, located (index, first divergent token),
    and ``app_replay_divergence`` above 0."""
    if not want_divergent:
        return ([] if report["divergent"] == 0 and report["compared"] > 0
                else [f"divergent {report['divergent']} of "
                      f"{report['compared']}"])
    located = [d for d in report["divergences"] if d["kind"] == "token"
               and "first_divergent_token" in d and "index" in d]
    faults = [] if located else ["nothing located"]
    if not report.get("metric", 0) > 0:
        faults.append(f"metric {report.get('metric')}")
    return faults


def _trace_kernel_names(path: str) -> set:
    """The kernel names of a Chrome trace written by ``ProfilerCapture``,
    without their parameter lists and namespaces."""
    if not Path(path).exists():
        return set()
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    names = set()
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "").replace("void ", "", 1)
            name = name.replace("(anonymous namespace)::", "")
            names.add(name.split("(", 1)[0])
    return names


def _profile_faults(run: dict) -> list:
    """(f): the trace names the decode and the chunk kernel (and the
    fused K/V write), a second start is refused, ``max_capture_s``
    stopped a capture, ``force`` recovered a leaked one, a start under
    another ``torch.profiler`` session is refused, digests with the
    capture on are the clean run's, decode tokens/s with the capture code
    armed and off >= 0.98 x the engine without it."""
    faults = []
    names = run["kernel_names"]
    for want in ("paged_decode", "paged_chunk", "rope_kv_write"):
        if not any(want in n for n in names):
            faults.append(f"no {want} kernel in the trace")
    if run["second_start"].get("ok") is not False:
        faults.append("second start accepted")
    if run["auto_stop"] != {"running": False, "auto_stops": 1}:
        faults.append(f"auto_stop {run['auto_stop']}")
    if run["forced"].get("recovered") is not True or run["leaked_stop"].get(
            "ok") is not False:
        faults.append(f"force {run['leaked_stop']} {run['forced']}")
    if run["under_other_profiler"].get("ok") is not False:
        faults.append("started under another torch.profiler session")
    faults += _digest_faults(run["digests"], run["clean_digests"])
    if not run["tokens_per_s_ratio"] >= 0.98:
        faults.append(f"tokens/s ratio {run['tokens_per_s_ratio']}")
    return faults


def phase_serve_recover(dev, smi_line: str, cfg=None) -> None:
    """The recovery and forensics planes on the card, through the port's
    app on ``cfg`` (default ``llama3_1b``; random weights, seed 0), greedy,
    ``serve_config`` (engine A, warmed up) unless said otherwise. Each
    wave is admitted as one batch (a gate on the queue's pop), so two
    runs batch alike. Every check is shown a planted fault in the same
    run and must reject it.

    (a) Containment: serve's waves 1-3 clean (captured as a workload,
        for (e)); then the group prefill's call raising once: wave 1
        answers one 500 (the failing group: each wave-1 prompt has a
        bucket of its own) and three 201s whose digests are the clean
        run's, and wave 2's digest is the clean run's. Planted: a
        containment that also failed a bystander.
    (b) Restart within budget, engine B (``prefill_buckets=(8,)``, one
        chunk round an admission, ``pipeline_depth=1``, a
        ``RestartPolicy``): a 3-token decoder and wave 1's four prompts
        (3 to 113 chunks each) queued before ``start()``; the decoder's
        first token comes at the end of the first iteration and its
        decode dispatch is in flight at depth 1 when ``pass_raise:at=3``
        fires at the top of the third, while no walker has a first token:
        the four walkers recover (``recovered``, replayed from offset 0)
        with the clean run's digests, the decoder answers 503
        ``engine_restart`` with ``Retry-After``, ``app_engine_restarts``
        1, ``app_engine_requests_recovered`` 4; ``graph_captures``,
        ``torch.cuda.memory_allocated()`` and the launches per replay
        as after the clean run. Planted: a recovered request replayed
        with its last prompt token dropped.
        Then on A, wave 1 as two unary ``/chat``, one SSE ``/chat`` and
        one ``/v1/completions`` queued before ``start()`` and
        ``pass_raise:at=2`` (after every first token): 503 with
        ``Retry-After`` and ``engine_restart`` on the unary ones, the
        stream's error event typed, no ``[DONE]``. Planted: the clean
        run's 201s.
    (c) Budget spent on A (``pass_raise:times=0``, two restarts left):
        DOWN, a ``restart_budget`` bundle at ``/debug/incidents?id=``
        (an unknown id 404), the next ``/chat`` a 503 ``engine_down``
        with ``Retry-After``. Planted: (b)'s within-budget state.
    (d) Spans: one ``/chat`` with a ``traceparent``: ``X-Trace-Id`` is its
        trace, the HTTP span is the caller's child, ``engine.request``
        the HTTP span's, and under it ``engine.queue``, the prefill
        spans, ``engine.decode`` and ``engine.retire``; the trace id is an
        exemplar on ``/metrics`` in OpenMetrics. Planted: the same checks
        on a garbage ``traceparent``, which must start a fresh trace.
    (e) Workload: (a)'s capture replayed on A at speed 1.0 (gated at the
        waves' sizes): 0 divergent requests; again under
        ``logit_corrupt``: at least one, located, and
        ``app_replay_divergence`` > 0. Each check is shown the other
        replay.
    (f) Profiler (``PROFILER_ENABLED=1``): start, wave 2, stop: the
        Chrome trace names the paged decode, paged chunk and fused K/V
        write kernels; a second start is refused; a start while this
        script's own ``torch.profiler`` session runs is refused; a
        capture with ``max_capture_s`` 0.5 stops itself; a leaked one
        only ``force`` recovers; digests with the capture on are the
        clean run's; decode tokens/s of A (profiler routes and
        autoprofiler armed, no capture) >= 0.98 x engine C's (no
        profiler code: ``autoprof=False``, no routes), best of three
        interleaved runs each, 4 x 256 greedy tokens. Planted: the idle
        auto-stopped capture's trace, the first start's answer, a status
        read before the timer, a plain stop of the leak, one bent
        digest, A's tokens/s x 0.9."""
    import tempfile

    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serving.app import serve_config
    from gofr_tpu_torch.serving.engine import RestartPolicy
    from gofr_tpu_torch.serving.faults import FaultPlan
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.integrity import request_digest
    from gofr_tpu_torch.serving.replay import parse_workload, replay_workload
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    from gofr_tpu_torch.tracing import InMemoryExporter, Tracer
    cfg = cfg or LlamaConfig.llama3_1b()
    cuda = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    tok = ByteTokenizer()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    failed: dict = {}
    planted: dict = {}
    out: dict = {"phase": "serve_recover", "card": smi_line}
    tmp = Path(tempfile.mkdtemp(prefix="gofr_recover_"))
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")
    long_prompt = (story * 30)[:1800]
    waves = [[(words * 20)[:n] for n in (20, 150, 400, 900)], [long_prompt],
             [(words * 20)[:900] + " but the question at the end is new",
              (words * 20)[:400] + " and this ending differs",
              long_prompt[:1795] + " until a new ending"]]

    def judge(name, faults, planted_faults):
        failed[name], planted[name] = faults, planted_faults

    def chat(prompt, max_tokens=32, **extra):
        return ("/chat", {"prompt": prompt, "max_tokens": max_tokens,
                          "temperature": 0, **extra}, False)

    def memory() -> int:
        if cuda:
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()
        return 0

    def digests(app, since):
        return {tuple(p): r.digest for p, r in app.made[since:]
                if r.error is None}

    def make(**kw):
        engine = llama_engine(params, cfg, serve_config(cfg, **kw),
                              device=dev)
        engine.warmup(prompt_lens=(16, 20, 60, 150, 400, 900), chunked=True)
        return engine

    # ------------------------------------------------ A: clean + capture
    tracer_spans = InMemoryExporter()
    a_engine = make(workload_capture=True)
    a = _GatedApp(a_engine, tok, tracer=Tracer(exporter=tracer_spans),
                  env={"PROFILER_ENABLED": "1",
                       "PROFILER_DIR": str(tmp / "profiles")})
    try:
        a_engine.start()
        clean_answers = []
        for wave in waves:
            clean_answers += a.ask([chat(p) for p in wave])
        a_engine.stop()
        if any(x[0] != 201 for x in clean_answers):
            raise AssertionError(f"serve_recover: a clean answer was not "
                                 f"201: {clean_answers}")
        clean = digests(a, 0)
        workload_text = a_engine.workload.to_jsonl()
        a_engine.workload.stop()

        # (a) the group prefill's call raises once
        inner = a_engine._prefill_fn
        left = {"n": 1}

        def failing_prefill(*args, **kwargs):
            if left["n"]:
                left["n"] -= 1
                raise RuntimeError("planted prefill fault")
            return inner(*args, **kwargs)

        a_engine._prefill_fn = failing_prefill
        since = len(a.made)
        a_engine.start()
        contained = a.ask([chat(p) for p in waves[0]])
        contained += a.ask([chat(waves[1][0])])
        a_engine.stop()
        a_engine._prefill_fn = inner
        statuses = [x[0] for x in contained]
        got = digests(a, since)

        def containment_faults(statuses, got):
            faults = []
            if sorted(statuses[:4]) != [201, 201, 201, 500] \
                    or statuses[4] != 201:
                faults.append(f"statuses {statuses}")
            faults += [f"digest_{len(p)}" for p in got if got[p] != clean[p]]
            if len(got) != 4:
                faults.append(f"{len(got)} answered")
            return faults

        bystander = dict(got)
        bystander.pop(next(iter(bystander)))
        judge("a_containment", containment_faults(statuses, got),
              containment_faults(
                  [500 if s == 201 and i == statuses.index(201) else s
                   for i, s in enumerate(statuses)], bystander))
        out["a"] = {"statuses": statuses,
                    "failed_error": [x[2]["error"]["message"]
                                     for x in contained if x[0] == 500]}

        # (d) spans
        trace_id, parent = "4bf92f3577b34da6a3ce929d0e0e4736", \
            "00f067aa0ba902b7"
        a_engine.start()

        def traced(header):
            status, headers, _ = _http_traced(a.port, waves[0][0], header)
            x_trace = headers.get("x-trace-id")
            deadline = time.time() + 10
            spans = []
            while time.time() < deadline:
                spans = [s for s in tracer_spans.spans
                         if s.trace_id == x_trace]
                if any(s.name == "POST /chat" for s in spans):
                    break
                time.sleep(0.01)
            http = next((s for s in spans if s.name == "POST /chat"), None)
            root = next((s for s in spans if s.name == "engine.request"),
                        None)
            tree = {}
            if http is not None and root is not None:
                tree = {"http_parent": http.parent_id,
                        "request_under_http": root.parent_id == http.span_id,
                        "children": [s.name for s in spans
                                     if s.parent_id == root.span_id]}
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:"
                    f"{a.metrics_server.server_address[1]}/metrics",
                    headers={"Accept": "application/openmetrics-text"}),
                    timeout=30) as resp:
                openmetrics = resp.read().decode()
            return {"status": status, "x_trace_id": x_trace, "tree": tree,
                    "inbound_parent": parent, "openmetrics": openmetrics}

        a.mark({1})
        good = traced(f"00-{trace_id}-{parent}-01")
        a.mark({1})
        garbage = traced("00-garbage-header-01")
        a_engine.stop()
        judge("d_spans", _span_faults(good, trace_id),
              _span_faults(garbage, trace_id))
        fresh = garbage["tree"].get("http_parent") is None and \
            garbage["x_trace_id"] not in (None, trace_id)
        judge("d_garbage_starts_a_fresh_trace",
              [] if fresh else ["garbage joined a trace"],
              [] if good["tree"].get("http_parent") is None
              else ["parented"])
        out["d"] = {"x_trace_id": good["x_trace_id"],
                    "children": good["tree"].get("children"),
                    "garbage_trace_id": garbage["x_trace_id"],
                    "spans_exported": len(tracer_spans.spans)}

        # (e) replay the capture, clean and under logit_corrupt
        workload = parse_workload(workload_text)
        reports = {}
        for name, plan in (("clean", ""), ("corrupt",
                                           "logit_corrupt:at=40,times=3")):
            a_engine.faults = FaultPlan.parse(plan)
            a.mark({4, 5, 8})
            metric0 = a.server.metrics.get("app_replay_divergence").get()
            t0 = time.perf_counter()
            report = replay_workload(a_engine, workload, speed=1.0,
                                     timeout_s=300)
            a_engine.stop()
            report["metric"] = a.server.metrics.get(
                "app_replay_divergence").get() - metric0
            report["seconds"] = time.perf_counter() - t0
            reports[name] = report
        a_engine.faults = FaultPlan.parse("")
        judge("e_replay_clean", _replay_faults(reports["clean"], False),
              _replay_faults(reports["corrupt"], False))
        judge("e_replay_located", _replay_faults(reports["corrupt"], True),
              _replay_faults(reports["clean"], True))
        out["e"] = {k: {key: r[key] for key in (
            "requests", "compared", "divergent", "divergences", "mode",
            "wall_s", "metric", "digest_divergence")}
            for k, r in reports.items()}

        # (f) decode tokens/s, before any capture moves A's pass costs:
        # A (profile routes and autoprofiler armed, no capture) against C
        c_engine = make(autoprof=False)
        c = _GatedApp(c_engine, tok)
        decode_asks = [chat(p, max_tokens=256) for p in waves[0]]
        rates = {"a": [], "c": []}
        try:
            for side in ("c", "a", "a", "c", "c", "a"):
                app = a if side == "a" else c
                eng = app.engine
                s0 = dict(eng.stats)
                eng.start()
                app.ask(decode_asks)
                eng.stop()
                rates[side].append(
                    (eng.stats["decode_tokens"] - s0["decode_tokens"])
                    / (eng.stats["decode_s"] - s0["decode_s"]))
        finally:
            c.close()
            del c_engine
        ratio = max(rates["a"]) / max(rates["c"])
        autoprof_before = a_engine.autoprof.state()["captures"]

        # (f) the profiler
        prof = a.server.profiler
        prof_run: dict = {"tokens_per_s_ratio": ratio}
        a_engine.start()
        a.mark({0})
        prof_run["first_start"] = _http_json(a.port, "POST",
                                             "/debug/profile/start", {})[2]
        prof_run["second_start"] = _http_json(a.port, "POST",
                                              "/debug/profile/start", {})[2]
        since = len(a.made)
        profiled = a.ask([chat(waves[1][0])])
        stopped = _http_json(a.port, "POST", "/debug/profile/stop", {})[2]
        prof_run["digests"] = digests(a, since)
        prof_run["clean_digests"] = {k: v for k, v in clean.items()
                                     if k in prof_run["digests"]}
        trace_path = Path(stopped["data"]["dir"] or "") / "trace.json"
        prof_run["kernel_names"] = sorted(
            n for n in _trace_kernel_names(str(trace_path))
            if any(k in n for k in ("paged", "rope_kv", "flash", "kv_write")))
        prof_run["trace_mb"] = (trace_path.stat().st_size / 2 ** 20
                                if trace_path.exists() else None)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            prof_run["under_other_profiler"] = _http_json(
                a.port, "POST", "/debug/profile/start", {})[2]["data"]
        timed = _http_json(a.port, "POST", "/debug/profile/start",
                           {"max_capture_s": 0.5})[2]["data"]
        early = prof.status()
        deadline = time.time() + 20
        while prof.status()["running"] and time.time() < deadline:
            time.sleep(0.02)
        late = prof.status()
        prof_run["auto_stop"] = {"running": late["running"],
                                 "auto_stops": late["auto_stops"]}
        idle_names = _trace_kernel_names(str(Path(timed.get("dir") or "")
                                             / "trace.json"))
        prof.start()
        prof._active_dir = None              # a failed stop lost the state
        prof_run["leaked_stop"] = _http_json(
            a.port, "POST", "/debug/profile/stop", {})[2]["data"]
        prof_run["forced"] = _http_json(
            a.port, "POST", "/debug/profile/stop", {"force": True})[2]["data"]
        a_engine.stop()
        prof_run["second_start"] = prof_run["second_start"]["data"]
        prof_run["first_start"] = prof_run["first_start"]["data"]
        if profiled[0][0] != 201:
            raise AssertionError(f"serve_recover: the profiled request "
                                 f"failed: {profiled}")

        bent = dict(prof_run["digests"])
        first_key = next(iter(bent))
        bent[first_key] = "0" * 32
        judge("f_profiler", _profile_faults(prof_run), _profile_faults(
            {**prof_run, "kernel_names": sorted(idle_names),
             "second_start": prof_run["first_start"],
             "auto_stop": {"running": early["running"],
                           "auto_stops": early["auto_stops"]},
             "leaked_stop": prof_run["forced"],
             "forced": prof_run["leaked_stop"],
             "under_other_profiler": prof_run["first_start"],
             "digests": bent, "tokens_per_s_ratio": ratio * 0.9}))
        out["f"] = {"kernel_names": prof_run["kernel_names"],
                    "trace_mb": prof_run["trace_mb"],
                    "second_start": prof_run["second_start"],
                    "under_other_profiler":
                    prof_run["under_other_profiler"],
                    "auto_stop": prof_run["auto_stop"],
                    "forced": prof_run["forced"],
                    "decode_tokens_per_s_profiler_armed": rates["a"],
                    "decode_tokens_per_s_no_profiler": rates["c"],
                    "ratio_best_of_three": ratio,
                    "autoprof_captures_through_rates": autoprof_before,
                    "autoprof": a_engine.autoprof.state(),
                    "drift_episodes": a_engine.costs.state()[
                        "drift_episodes"]}

        # (b) on A, after every first token: typed answers
        a_engine.faults = FaultPlan.parse("pass_raise:at=2")
        a_engine.config.restart_policy = RestartPolicy(max_restarts=3,
                                                       backoff_s=0.05)
        mid = a.ask([chat(waves[0][0], 64), chat(waves[0][1], 64),
                     ("/chat", {"prompt": waves[0][2], "max_tokens": 64,
                                "temperature": 0, "stream": True}, True),
                     ("/v1/completions", {"prompt": waves[0][3],
                                          "max_tokens": 64,
                                          "temperature": 0}, False)],
                    before_start=True)
        a_engine.stop()
        judge("b_midstream_typed", _midstream_faults(mid),
              _midstream_faults(clean_answers[:4]))
        out["b_midstream"] = [
            (x["status"], (x["events"][-1][1] if x["events"] else None))
            if isinstance(x, dict) else (x[0], x[1].get("retry-after"),
                                         x[2].get("error"))
            for x in mid]

        # (c) the budget spent
        a_engine.faults = FaultPlan.parse("pass_raise:times=0")
        a_engine.config.restart_policy = RestartPolicy(
            max_restarts=a_engine._restarts + 2, backoff_s=0.05)
        a.mark({1})
        a_engine.start()
        deadline = time.time() + 30
        while a_engine.health_check()["status"] != "DOWN" \
                and time.time() < deadline:
            time.sleep(0.01)
        status, _, listing = _http_json(a.port, "GET", "/debug/incidents")
        bundles = listing["data"]["llama3_1b"]["incidents"]
        budget = [b for b in bundles if b["reason"] == "restart_budget"]
        bundle_status, _, bundle = _http_json(
            a.port, "GET", f"/debug/incidents?id={budget[-1]['id']}") \
            if budget else (None, None, {"data": {}})
        next_status, next_headers, next_body = _http_json(
            a.port, "POST", "/chat", chat("after the crash")[1])
        budget_run = {
            "health": a_engine.health_check()["status"],
            "restarts": a_engine._restarts,
            "bundle_status": bundle_status,
            "bundle_reason": bundle["data"].get("reason"),
            "bundle_events": [e["kind"] for e in
                              bundle["data"].get("timeline", [])][-6:],
            "next": (next_status, next_headers.get("retry-after"),
                     ((next_body.get("error") or {}).get("details") or {})
                     .get("code")),
            "unknown_id_status": _http_json(
                a.port, "GET", "/debug/incidents?id=nope")[0]}
    finally:
        a.close()
    del a_engine
    gc.collect()

    # (b) engine B: walkers with no first token, a decode in flight
    b_engine = make(prefill_buckets=(8,), prefill_chunks_per_pass=1,
                    pipeline_depth=1)
    b = _GatedApp(b_engine, tok)
    asks = [chat("go", 64)] + [chat(p) for p in waves[0]]
    decoder = tok.encode("go")
    runs = {}
    try:
        for name, plan in (("clean", ""), ("faulted", "pass_raise:at=3")):
            b_engine.faults = FaultPlan.parse(plan)
            b_engine.config.restart_policy = RestartPolicy(max_restarts=3,
                                                           backoff_s=0.05)
            m_restarts = b.server.metrics.get("app_engine_restarts").get()
            m_recovered = b.server.metrics.get(
                "app_engine_requests_recovered").get()
            since = len(b.made)
            answers = b.ask(asks, before_start=True)
            b_engine.stop()
            walkers = [(p, r) for p, r in b.made[since:] if p != decoder]
            runs[name] = {
                "walkers": 4,
                "recovered": sum(r.recovered for _, r in walkers),
                "restarts_metric": b.server.metrics.get(
                    "app_engine_restarts").get() - m_restarts,
                "recovered_metric": b.server.metrics.get(
                    "app_engine_requests_recovered").get() - m_recovered,
                "digests": {tuple(p): r.digest for p, r in walkers},
                "requests": [r for _, r in walkers],
                "decoder": (answers[0][0], ((answers[0][2].get("error")
                                             or {}).get("details") or {})
                            .get("code"), answers[0][1].get("retry-after")),
                "walker_statuses": [x[0] for x in answers[1:]],
                "graph_captures": b_engine.stats["graph_captures"],
                "memory_allocated": memory(),
                "launches_per_replay": {
                    str(g): {f"{fn.__name__}.{attr}": n
                             for (fn, attr), n in launched.items()}
                    for g, launched in
                    b_engine._decode_graph._graph_launches.items()}}
    finally:
        b.close()
    del b_engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    faulted, clean_b = runs["faulted"], runs["clean"]
    if faulted["walker_statuses"] != [201] * 4:
        raise AssertionError(f"serve_recover: a recovered request was not "
                             f"answered: {faulted['walker_statuses']}")
    dropped = dict(faulted)
    req = faulted["requests"][-1]
    dropped["digests"] = {**faulted["digests"], tuple(req.prompt_tokens):
                          request_digest(req.prompt_tokens[:-1], req.params,
                                         req.generated)}
    judge("b_restart_recovers", _recovered_faults(faulted, clean_b),
          _recovered_faults(dropped, clean_b))
    out["b"] = {k: {key: r[key] for key in (
        "recovered", "restarts_metric", "recovered_metric", "decoder",
        "walker_statuses", "graph_captures", "memory_allocated",
        "launches_per_replay")} for k, r in runs.items()}
    judge("c_budget_spent", _budget_faults(budget_run),
          _budget_faults({**budget_run, "health": "UP",
                          "bundle_reason": None, "next": (201, None, None)}))
    out["c"] = budget_run
    out.update(failed_checks=failed, planted=planted,
               seconds=time.perf_counter() - t_phase)
    emit(out)
    bad = {k: v for k, v in failed.items() if v}
    if bad:
        raise AssertionError(f"serve_recover: checks failed: {bad}")
    missed = [k for k, v in planted.items() if not v]
    if missed:
        raise AssertionError(f"serve_recover: planted faults passed every "
                             f"check: {missed}")


FLEET_HEARTBEAT_S = 0.2
FLEET_NEW = 32
#: wave 2's suffix lengths, each family's six requests (bytes = tokens)
FLEET_SUFFIXES = (40, 48, 56, 72, 96, 120)
#: the (d) and (e) requests' suffixes: at most 64 tokens, so a prompt
#: pins no key past its family's 512 rows and a re-serve of it walks the
#: same path
FLEET_SOLO_SUFFIXES = (44, 52, 60)
#: (e)'s stream: long enough to outlast the two retried requests
FLEET_STREAM_NEW = 512


def _fleet_families(tok) -> dict:
    """Two families, each led by its own system prompt of 511 bytes (512
    tokens with the byte tokenizer's BOS: 8 pages of 64 rows)."""
    texts = {"A": "You are the billing assistant of a small utility. "
                  "Answer questions about invoices, meter readings and "
                  "payment plans politely and briefly. ",
             "B": "You are the release engineer on call for a build farm. "
                  "Explain failing jobs, flaky tests and cache misses "
                  "step by step, quoting the log lines. "}
    out = {}
    for name, text in texts.items():
        system = (text * 8)[:511]
        assert len(tok.encode(system)) == 512
        out[name] = system
    return out


def _suffix(family: str, tag: str, n: int) -> str:
    """``n`` bytes whose first bytes differ per request, so no two
    requests share a page past their family's prefix."""
    head = f"[{family}{tag}] question: "
    body = "how does the next step depend on the previous one and why? "
    return (head + body * 4)[:n]


def _fleet_chat(port: int, prompt: str, n_new: int = FLEET_NEW):
    status, _, body = _http_json(port, "POST", "/chat",
                                 {"prompt": prompt, "max_tokens": n_new,
                                  "temperature": 0})
    return status, body


def _digest_of(tok, prompt: str, tokens: list, n_new: int = FLEET_NEW):
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.integrity import request_digest
    return request_digest(tok.encode(prompt), SamplingParams(
        temperature=0.0, top_p=1.0, top_k=0, max_new_tokens=n_new), tokens)


def _sse_tokens(run: dict) -> tuple[list, float | None]:
    """(token ids, seconds to the first) of an ``_sse_call`` record."""
    hits = [(t, e["token"]) for t, e in run["events"]
            if isinstance(e, dict) and "token" in e]
    return [tk for _, tk in hits], (hits[0][0] if hits else None)


def _registry_faults(docs: dict, kind: str, hbm_used: float,
                     weight_bytes: int) -> list:
    out = []
    for name, doc in docs.items():
        devices = ((doc.get("devices") or {}).get("details") or {}) \
            .get("devices") or []
        if [d.get("kind") for d in devices] != [kind]:
            out.append(f"{name}: devices {[d.get('kind') for d in devices]}"
                       f", not one {kind!r}")
    if hbm_used < weight_bytes:
        out.append(f"app_gpu_hbm_bytes_used {hbm_used} < the engines' "
                   f"weights {weight_bytes}")
    return out


def _owner_faults(view: list, family_hashes: dict) -> list:
    out = []
    for fam, h in family_hashes.items():
        holders = [m["host_id"] for m in view
                   if h in ((m.get("summary") or {}).get("prefix_digest")
                            or {}).get("hashes", [])]
        if len(holders) != 1:
            out.append(f"family {fam}'s 512-row hash in {holders}")
    return out


def _routing_faults(run: dict, owners: dict, per_family: int) -> list:
    """Every request of a family routed to its owner, whose prefix hits
    rose once per request; nothing routed elsewhere."""
    want: dict = {}
    for fam, host in owners.items():
        want[host] = want.get(host, 0) + per_family
    out = []
    for host in sorted(set(want) | set(run["routed"])):
        if run["routed"].get(host, 0) != want.get(host, 0):
            out.append(f"{host}: routed {run['routed'].get(host, 0)}, "
                       f"want {want.get(host, 0)}")
        if run["hits"].get(host, 0) != want.get(host, 0):
            out.append(f"{host}: prefix hits +{run['hits'].get(host, 0)}"
                       f", want +{want.get(host, 0)}")
    return out + [f"status {s}" for s in run["statuses"] if s != 201]


def _same_answer_faults(answers: list) -> list:
    """Each (prompt, [digest, ...]) must hold one digest."""
    return [f"{p[-24:]!r}: {len(set(ds))} digests" for p, ds in answers
            if len(set(ds)) != 1 or None in ds]


def _quarantine_faults(vote: dict, divergences: list, bundles: list,
                       bad: str, clean: tuple) -> list:
    out = []
    if sorted(vote.get("quarantined") or {}) != [bad]:
        out.append(f"quarantined {sorted(vote.get('quarantined') or {})}, "
                   f"not [{bad}]")
    named = [e.get("attrs", {}).get("outlier") for e in divergences]
    if named != [bad]:
        out.append(f"divergence events name {named}")
    if len(bundles) != 1:
        out.append(f"{len(bundles)} integrity_divergence bundles")
    for host in clean:
        if host in named or host in (vote.get("quarantined") or {}):
            out.append(f"clean host {host} named")
    return out


def _stream_faults(stream: dict, n_new: int, engine_digest: str | None,
                   digest: str | None) -> list:
    out = []
    if not stream["terminal"] or stream["events"][-1][1] != "[DONE]":
        out.append("no terminal [DONE]")
    if len(stream["tokens"]) != n_new:
        out.append(f"{len(stream['tokens'])} tokens streamed, not {n_new}")
    if digest != engine_digest:
        out.append("streamed tokens are not the engine's")
    return out


def _federation_faults(text: str, hosts: tuple) -> list:
    out = []
    for host in hosts:
        for family in ("app_engine_", "app_gpu_"):
            if not any(line.startswith(family) and f'host="{host}"' in line
                       for line in text.splitlines()):
                out.append(f"no {family}* series of {host}")
    for family in ("app_fleet_", "app_router_"):
        if not any(line.startswith(family) for line in text.splitlines()):
            out.append(f"no {family}* series")
    return out


def _eviction_faults(topo: dict, gone: str, survivors: dict,
                     evictions: dict, waited_s: float,
                     floor_s: float) -> list:
    out = []
    if gone in topo["members"]:
        out.append(f"{gone} still a member")
    ranks = {h: m["rank"] for h, m in topo["members"].items()}
    if sorted(ranks.values()) != list(range(len(ranks))):
        out.append(f"ranks {ranks} not contiguous")
    if survivors != {h: r for h, r in ranks.items()}:
        out.append(f"survivors hold {survivors}, leader says {ranks}")
    if evictions != {"heartbeat_timeout": 1.0}:
        out.append(f"evictions {evictions}")
    if waited_s < floor_s:
        out.append(f"evicted after {waited_s:.3f} s of silence < "
                   f"{floor_s} s")
    return out


def phase_serve_fleet(dev, smi_line: str) -> None:
    """The fleet plane on the card: three ``llama3_1b`` workers (random
    weights from seed 0, ``serve_config``, golden probes every 2 passes
    from a corpus sealed here from a clean engine's greedy answer; the
    third with ``logit_corrupt`` scoped to the probe tenant), each joined
    with ``join_fleet`` at a 0.2 s heartbeat to one
    ``serve_fleet_leader(router=RouterConfig())`` with ``eviction_misses``
    3. Two request families, each led by its own 512-token system prompt
    (8 pages), greedy, 32 new tokens, byte tokenizer. In order:

    (a) each worker's health lists one device of ``nvidia-smi``'s name;
        ``app_gpu_hbm_bytes_used`` >= the weight bytes of the three
        engines. Planted: a registry asked for the CPU.
    (f) direct requests to every worker until the leader's vote (quorum
        3) quarantines the third: its local mismatch episode opened once,
        exactly it named, one ``fleet.integrity_divergence`` event and
        one incident bundle, the clean pair never named; it leaves the
        routing view and its routed share stays 0 to the end. Planted:
        an offline leader fed the three summaries with the second clean
        host's probe digests swapped for the corrupt one's. The canaries
        pause once the vote is in, so the latencies below are the
        requests' own.
    (b) wave 1, one request per family through the router: each family's
        512-row hash reaches the leader's routing view in exactly one
        worker's digest (seconds recorded). Planted: the 511-row hash, as
        a router with the wrong page size would look for.
    (c) wave 2, 6 requests per family all at once: every one on its
        family's owner, whose prefix hits rise once per request. Planted:
        the same wave through a fresh round-robin leader.
    (d) per family, three prompts served one at a time: routed unary,
        routed SSE and direct SSE on the owner give one digest each.
        Router's added TTFT: the p50 of routed minus direct SSE TTFT,
        the two SSE calls of a prompt in turns. Planted: a routed answer
        with one token flipped.
    (e) family A's owner drained with one 512-token stream in flight:
        new family-A requests draw typed ``draining`` 503s and are retried
        on the survivor, equal to the same prompts served there directly;
        the stream ends with ``[DONE]``, its tokens the engine's own.
        Planted: the stream with its last token repeated.
    (h) ``/control/fleet/metrics``: every worker's ``app_engine_*`` and
        ``app_gpu_*`` under its ``host`` label, the leader's
        ``app_fleet_*`` and ``app_router_*``. Planted: one host's lines
        dropped.
    (g) the drained worker's agent stopped: evicted after 3 missed
        intervals (``heartbeat_timeout``, the only eviction of the run),
        the generation bumped once, the survivors re-ranked contiguously.
        Planted: the topology before the eviction.
    (i) the launches of the routed waves and (d): flash, chunk, decode,
        ``rope_kv_write`` and the prefill's slab write, each > 0.
        Planted: the counts before the waves."""
    import tempfile

    import torch
    from gofr_tpu_torch.device import DeviceRegistry
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write, scatter_chunk_kv
    from gofr_tpu_torch.ops.quant import quantized_bytes
    from gofr_tpu_torch.serving.app import (build_engine, build_server,
                                            join_fleet, serve_config,
                                            serve_fleet_leader)
    from gofr_tpu_torch.serving.control_plane import ControlPlaneLeader
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.integrity import GoldenSet, request_digest
    from gofr_tpu_torch.serving.logger import Logger, clear_fleet_context
    from gofr_tpu_torch.serving.router import RouterConfig, prefix_hash
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama3_1b()
    tok = ByteTokenizer()
    names = ("w0", "w1", "w2")
    bad = "w2"
    smi_name = smi_line.split(",")[0].strip()
    tmp = tempfile.mkdtemp(prefix="gofr_fleet_")
    log = open(Path(tmp) / "fleet.log", "w")
    quiet = Logger(out=log)
    counters = {"flash_attention": (flash_attention, "launches"),
                "paged_decode_attention": (paged_decode_attention,
                                           "launches"),
                "paged_chunk_attention": (paged_chunk_attention, "launches"),
                "rope_kv_write": (rope_kv_write, "launches"),
                "scatter_chunk_kv": (scatter_chunk_kv, "launches")}
    failed: dict = {}
    planted: dict = {}
    out: dict = {"phase": "serve_fleet", "card": smi_line}

    def judge(name, faults, planted_faults):
        failed[name], planted[name] = faults, planted_faults

    # the golden corpus: one canary of 50 tokens (a bucket of 64 rows no
    # client prompt uses), sealed from a clean engine's greedy answer
    golden_prompt = tok.encode(("golden canary: count the pages of the "
                                "pool and name them ") * 2)[:50]
    golden_params = SamplingParams(temperature=0.0, max_new_tokens=16)
    sealer = build_engine(cfg)
    sealer.start()
    try:
        req = sealer.submit(golden_prompt, golden_params)
        req.done.wait(120)
        assert req.error is None and len(req.generated) == 16, req.error
    finally:
        sealer.stop()
    golden_path = str(Path(tmp) / "golden.jsonl")
    GoldenSet.seal([{"prompt_tokens": golden_prompt,
                     "digest": request_digest(req.prompt_tokens, req.params,
                                              req.generated),
                     "params": {"temperature": 0.0, "top_p": 1.0,
                                "top_k": 0, "max_new_tokens": 16}}]
                   ).save(golden_path)
    sealed_digest = GoldenSet.load(golden_path).entries[0].digest
    del sealer, req
    gc.collect()
    # the process's own pauses, which silence every heartbeat at once:
    # each collection's length, and the leader's sweeper stalls below
    collections_s: list = []
    gc_began = [0.0]

    def gc_timer(when, info):
        if when == "start":
            gc_began[0] = time.perf_counter()
        else:
            collections_s.append(time.perf_counter() - gc_began[0])

    gc.callbacks.append(gc_timer)

    leader_server = serve_fleet_leader(
        router=RouterConfig(), heartbeat_interval_s=FLEET_HEARTBEAT_S,
        eviction_misses=3, logger=quiet)
    leader = leader_server.leader
    router = leader.router
    threads = [threading.Thread(target=leader_server.serve_forever,
                                args=(0.05,), daemon=True)]
    threads[0].start()
    leader_url = f"http://127.0.0.1:{leader_server.port}"
    lport = leader_server.port
    workers: dict = {}
    servers = [leader_server]
    t_boot = time.perf_counter()
    try:
        for name in names:
            faults = ("logit_corrupt:times=0,request=_integrity"
                      if name == bad else None)
            engine = build_engine(cfg, engine_config=serve_config(
                cfg, integrity_golden_path=golden_path,
                integrity_probe_passes=2, faults=faults))
            engine.warmup(prompt_lens=(50, 100, 600), chunked=True)
            server = build_server(engine, tok, port=0, name="llama3_1b",
                                  logger=quiet)
            servers.append(server)
            t = threading.Thread(target=server.serve_forever, args=(0.05,),
                                 daemon=True)
            t.start()
            threads.append(t)
            engine.start()
            workers[name] = {"engine": engine, "server": server,
                             "port": server.port}
        # joined once every engine is built and warm: a heartbeat thread
        # starved by a neighbour's warmup would miss its beats
        for name, w in workers.items():
            w["agent"] = join_fleet(w["server"], leader_url, host_id=name,
                                    heartbeat_interval_s=FLEET_HEARTBEAT_S,
                                    logger=quiet)
        deadline = time.time() + 60
        while len(leader.routing_view()) < 3:
            assert time.time() < deadline, "workers never joined"
            time.sleep(0.01)
        out["boot_s"] = time.perf_counter() - t_boot

        # (a) the registry
        docs = {n: _http_json(w["port"], "GET", "/.well-known/health")[2][
            "data"] for n, w in workers.items()}
        # a fresh probe: the registry caches for 10 s, since before the
        # later engines were built
        workers["w0"]["server"].devices.devices(refresh=True)
        snap = workers["w0"]["server"].metrics_snapshot()
        hbm = max((s["value"] for s in snap["metrics"][
            "app_gpu_hbm_bytes_used"]["series"]), default=0.0)
        weight_bytes = sum(quantized_bytes(w["engine"].params)
                           for w in workers.values())
        judge("a_registry",
              _registry_faults(docs, smi_name, hbm, weight_bytes),
              _registry_faults({"cpu": {"devices": DeviceRegistry(
                  device="cpu").device_health()}}, smi_name, hbm,
                  weight_bytes))
        out["a"] = {"kinds": {n: [d["kind"] for d in
                                  doc["devices"]["details"]["devices"]]
                              for n, doc in docs.items()},
                    "app_gpu_hbm_bytes_used": hbm,
                    "weight_bytes_3_engines": weight_bytes,
                    "device_count": torch.cuda.device_count()}

        # (f) probes until the vote quarantines the corrupt worker
        t_probe = time.perf_counter()
        tick = 0
        deadline = time.time() + 120

        def probes_done():
            w2 = workers[bad]["engine"].integrity
            return (bad in leader.fleet_status()["integrity"]["quarantined"]
                    and w2.probes.get("mismatch", 0) >= 2
                    and all(workers[n]["engine"].integrity.probes.get(
                        "run", 0) >= 1 for n in names))

        while not probes_done():
            assert time.time() < deadline, "no quarantine within 120 s"
            for n in names:
                # 32 tokens: a bucket of its own, and no page to pin
                text = (f"tick {tick} on {n}: keep the passes flowing")[:31]
                _fleet_chat(workers[n]["port"], text, 8)
                tick += 1
        rounds = leader.metrics.get("app_fleet_heartbeats").get(host=bad)
        vote = leader.fleet_status()["integrity"]
        divergences = leader.events.snapshot(
            kind="fleet.integrity_divergence")
        bundles = [b for b in leader.incidents.list()
                   if b["reason"] == "integrity_divergence"]
        status_of = {m["host_id"]: m["status"]
                     for m in leader.routing_view()}
        # planted: the same summaries with the second clean host's probe
        # digests swapped for the corrupt one's (a corrupt majority)
        offline = ControlPlaneLeader(host_id="offline")
        sums = {n: workers[n]["agent"].summary_source() for n in names}
        sums["w1"]["integrity"] = dict(sums[bad]["integrity"])
        for n in names:
            offline.join(n, "", 1)
            offline.heartbeat(n, -1, {"status": "UP"}, sums[n])
        integ = {n: workers[n]["engine"].integrity for n in names}
        local = ([f"{n}: {integ[n].episodes} local episodes"
                  for n in (bad,) if integ[n].episodes != 1]
                 + [f"{n}: {integ[n].probes.get('mismatch', 0)} mismatches"
                    for n in names if n != bad
                    and integ[n].probes.get("mismatch", 0)]
                 + ([] if status_of.get(bad) == "QUARANTINED" else
                    [f"{bad} is {status_of.get(bad)} in the routing view"]))
        clean = tuple(n for n in names if n != bad)
        judge("f_quarantine",
              _quarantine_faults(vote, divergences, bundles, bad, clean)
              + local,
              _quarantine_faults(
                  offline._vote_integrity(),
                  offline.events.snapshot(kind="fleet.integrity_divergence"),
                  [b for b in offline.incidents.list()
                   if b["reason"] == "integrity_divergence"], bad, clean))
        out["f"] = {"probe_phase_s": time.perf_counter() - t_probe,
                    "ticks": tick,
                    "heartbeat_rounds_to_quarantine": rounds,
                    "probes": {n: dict(integ[n].probes) for n in names},
                    "local_episodes": {n: integ[n].episodes for n in names},
                    "vote": {g: {"majority": v["majority"] == sealed_digest,
                                 "tally": sorted(v["tally"].values()),
                                 "voters": v["voters"]}
                             for g, v in vote["votes"].items()},
                    "routing_status": status_of}
        hb_body = {"host_id": "w0", "generation": 1,
                   "health": workers["w0"]["agent"].health_source(),
                   "summary": workers["w0"]["agent"].summary_source(),
                   "events": workers["w0"]["engine"].events.digest(),
                   "metrics": workers["w0"]["agent"].metrics_source()}
        out["heartbeat_body_bytes"] = len(json.dumps(hb_body))

        # the vote is in: the canaries pause, so the latencies below are
        # the requests' own
        for w in workers.values():
            w["engine"].integrity.probe_passes = 0
        deadline = time.time() + 60
        while any(w["engine"].integrity.inflight for w in workers.values()):
            assert time.time() < deadline, "a probe never ended"
            time.sleep(0.005)

        families = _fleet_families(tok)
        fam_hash = {f: prefix_hash(tok.encode(s)) for f, s in
                    families.items()}
        wrong_hash = {f: prefix_hash(tok.encode(s)[:511]) for f, s in
                      families.items()}

        def hits():
            return {n: w["engine"].stats["prefix_hits"]
                    for n, w in workers.items()}

        def routed(r):
            return dict(r.debug_state()["routed"])

        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        # (b) wave 1, one request per family, one after the other
        t_answer = {}
        for fam, system in families.items():
            status, _ = _fleet_chat(lport, system + _suffix(fam, "w1", 40))
            assert status == 201, status
            t_answer[fam] = time.perf_counter()
        seen_at: dict = {}
        deadline = time.time() + 30
        while len(seen_at) < len(families) and time.time() < deadline:
            view = leader.routing_view()
            for fam, h in fam_hash.items():
                if fam not in seen_at and any(
                        h in ((m["summary"].get("prefix_digest") or {})
                              .get("hashes") or []) for m in view):
                    seen_at[fam] = time.perf_counter() - t_answer[fam]
            time.sleep(0.005)
        view = leader.routing_view()
        owners = {}
        for fam, h in fam_hash.items():
            holders = [m["host_id"] for m in view if h in (
                (m["summary"].get("prefix_digest") or {}).get("hashes")
                or [])]
            owners[fam] = holders[0] if holders else None
        judge("b_digest", _owner_faults(view, fam_hash),
              _owner_faults(view, wrong_hash))
        out["b"] = {"digest_propagation_s": seen_at, "owners": owners}

        # (c) wave 2 through the prefix router, then a round-robin one
        wave2 = [(fam, families[fam] + _suffix(fam, f"w2.{i}", n))
                 for fam in families for i, n in enumerate(FLEET_SUFFIXES)]

        def run_wave(port, r):
            h0, r0 = hits(), routed(r)
            got: list = [None] * len(wave2)

            def ask(i, prompt):
                got[i] = _fleet_chat(port, prompt)

            t0 = time.perf_counter()
            ts = [threading.Thread(target=ask, args=(i, p))
                  for i, (_, p) in enumerate(wave2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(600)
            h1, r1 = hits(), routed(r)
            return {"wall_s": time.perf_counter() - t0,
                    "statuses": [g[0] for g in got],
                    "ttft_ms": sorted(g[1]["data"]["usage"]["ttft_ms"]
                                      for g in got if g[0] == 201),
                    "routed": {h: r1.get(h, 0) - r0.get(h, 0)
                               for h in r1 if r1.get(h, 0) - r0.get(h, 0)},
                    "hits": {h: h1[h] - h0[h] for h in h1
                             if h1[h] - h0[h]}}

        prefix_run = run_wave(lport, router)
        rr_server = serve_fleet_leader(
            router=RouterConfig(policy="round_robin"), host_id="rr-leader",
            heartbeat_interval_s=60.0, logger=quiet)
        servers.append(rr_server)
        t = threading.Thread(target=rr_server.serve_forever, args=(0.05,),
                             daemon=True)
        t.start()
        threads.append(t)
        for n in clean:
            rr_server.leader.join(n, f"127.0.0.1:{workers[n]['port']}", 1)
        rr_run = run_wave(rr_server.port, rr_server.leader.router)
        judge("c_prefix_routing", _routing_faults(prefix_run, owners, 6),
              _routing_faults(rr_run, owners, 6))
        out["c"] = {"prefix": prefix_run, "round_robin": rr_run,
                    "prefix_hits": {"prefix": sum(prefix_run["hits"].values()),
                                    "round_robin": sum(rr_run["hits"]
                                                       .values())}}
        rr_server.shutdown()
        rr_server.server_close()
        servers.remove(rr_server)

        # (d) one at a time: routed unary, routed SSE, direct SSE
        answers, ttft = [], {"routed": [], "direct": []}
        for fam, system in families.items():
            owner = owners[fam]
            for i, n in enumerate(FLEET_SOLO_SUFFIXES):
                prompt = system + _suffix(fam, f"d{i}", n)
                body = {"prompt": prompt, "max_tokens": FLEET_NEW,
                        "temperature": 0}
                status, unary = _fleet_chat(lport, prompt)
                # the two SSE calls in turns, so neither always goes first
                calls = [(lport, "routed"), (workers[owner]["port"],
                                             "direct")]
                if i % 2:
                    calls.reverse()
                sse = {key: _sse_call(port, "/chat", {**body,
                                                      "stream": True})
                       for port, key in calls}
                routed_sse, direct_sse = sse["routed"], sse["direct"]
                digests = [_digest_of(tok, prompt, unary["data"]["tokens"])
                           if status == 201 else None]
                for run, key in ((routed_sse, "routed"),
                                 (direct_sse, "direct")):
                    tokens, first = _sse_tokens(run)
                    digests.append(_digest_of(tok, prompt, tokens)
                                   if run["terminal"] else None)
                    ttft[key].append(first * 1000.0 if first else None)
                answers.append((prompt, digests))
        flipped = [(p, [ds[0], _digest_of(tok, p, [1] * FLEET_NEW)]
                    + ds[2:]) for p, ds in answers]
        judge("d_answers", _same_answer_faults(answers),
              _same_answer_faults(flipped))
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        judge("i_launches",
              [f"{k} never launched" for k, v in launches.items() if v < 1],
              [f"{k} never launched" for k in launches])
        p50 = {k: statistics.median(v) for k, v in ttft.items()
               if all(x is not None for x in v)}
        added = [r - d for r, d in zip(ttft["routed"], ttft["direct"])
                 if r is not None and d is not None]
        out["d"] = {"requests": len(answers),
                    "ttft_ms_p50": p50,
                    "router_added_ttft_ms_p50":
                    statistics.median(added) if added else None,
                    "ttft_ms": ttft}
        out["launches"] = launches

        # (e) drain family A's owner with one stream in flight
        owner = owners["A"]
        survivors = [n for n in clean if n != owner]
        survivor = survivors[0]
        # the survivor holds family A's prefix from a request served
        # alone, so a retried request and its direct reference walk the
        # same pages; the sessions pin the stream and the new requests
        # to the owner, which the survivor now ties on coverage
        assert _fleet_chat(workers[survivor]["port"], families["A"]
                           + _suffix("A", "w1", 40))[0] == 201
        sessions = ("A-stream", "A-0", "A-1")
        for session in sessions:
            router.affinity.put(session, owner)
        retries0 = router.debug_state()["retries"]
        first = threading.Event()
        stream: dict = {}
        long_prompt = families["A"] + _suffix("A", "e.stream", 48)

        def run_stream():
            stream.update(_sse_call(lport, "/chat", {
                "prompt": long_prompt, "max_tokens": FLEET_STREAM_NEW,
                "temperature": 0, "stream": True, "session": sessions[0]},
                first_event=first))

        st = threading.Thread(target=run_stream)
        st.start()
        assert first.wait(120), "the stream never started"
        drainer = threading.Thread(
            target=workers[owner]["engine"].drain, kwargs={"timeout_s": 120})
        drainer.start()
        deadline = time.time() + 30
        while not workers[owner]["engine"]._draining:
            assert time.time() < deadline, "drain never began"
            time.sleep(0.001)
        retried = []
        # one after the other: each walks alone on the survivor, as its
        # direct reference will
        for i, n in enumerate((44, 60)):
            prompt = families["A"] + _suffix("A", f"e{i}", n)
            status, _, body = _http_json(lport, "POST", "/chat", {
                "prompt": prompt, "max_tokens": FLEET_NEW, "temperature": 0,
                "session": sessions[1 + i]})
            retried.append((prompt, status, body))
        st.join(300)
        drainer.join(300)
        stream["tokens"], _ = _sse_tokens(stream)
        engine_digest = next(
            (r["digest"] for r in workers[owner]["engine"].recorder.snapshot()
             ["requests"] if r["generated"] == FLEET_STREAM_NEW), None)
        stream_digest = _digest_of(tok, long_prompt, stream["tokens"],
                                   FLEET_STREAM_NEW)
        repeated = dict(stream, tokens=stream["tokens"]
                        + stream["tokens"][-1:])
        retry_events = [(e["cause"], e["attrs"]["host"]) for e in
                        leader.events.snapshot(kind="router.retry")]
        direct = [_fleet_chat(workers[survivor]["port"], p)
                  for p, _, _ in retried]
        pairs = [(p, [_digest_of(tok, p, b["data"]["tokens"])
                      if s == 201 else None,
                      _digest_of(tok, p, d[1]["data"]["tokens"])
                      if d[0] == 201 else None])
                 for (p, s, b), d in zip(retried, direct)]
        retry_faults = ([] if retry_events[-2:] == [("draining", owner)] * 2
                        else [f"router.retry events {retry_events[-2:]}"]) \
            + ([] if router.debug_state()["retries"] - retries0 == 2
               else ["retries did not rise by 2"])
        judge("e_failover",
              _stream_faults(stream, FLEET_STREAM_NEW, engine_digest,
                             stream_digest)
              + _same_answer_faults(pairs) + retry_faults,
              _stream_faults(repeated, FLEET_STREAM_NEW, engine_digest,
                             _digest_of(tok, long_prompt,
                                        repeated["tokens"],
                                        FLEET_STREAM_NEW)))
        out["e"] = {"drained": owner, "survivor": survivor,
                    "retried_statuses": [s for _, s, _ in retried],
                    "retry_events": retry_events[-2:],
                    "stream_tokens": len(stream["tokens"]),
                    "stream_terminal": stream.get("terminal"),
                    "drain_health": workers[owner]["engine"]
                    .health_check()["status"]}

        # (h) federation
        status, _, _ = _http_json(lport, "GET", "/debug/fleet")
        conn_text = urllib.request.urlopen(
            leader_url + "/control/fleet/metrics", timeout=60).read().decode()
        dropped = "\n".join(line for line in conn_text.splitlines()
                            if 'host="w1"' not in line)
        judge("h_federation", _federation_faults(conn_text, names)
              + ([] if status == 200 else [f"/debug/fleet {status}"]),
              _federation_faults(dropped, names))
        out["h"] = {"fleet_metrics_bytes": len(conn_text),
                    "series": sum(1 for line in conn_text.splitlines()
                                  if line and not line.startswith("#"))}

        # (f)'s last word: the quarantined host was never routed to
        share = router.debug_state()["routed"]
        if share.get(bad, 0):
            failed["f_quarantine"].append(f"{bad} routed {share[bad]} times")
        out["routed"] = share

        # (g) eviction: stop the drained worker's agent
        generation = leader.generation
        before = leader.topology()
        workers[owner]["agent"].stop()
        t_stop = time.perf_counter()
        deadline = time.time() + 30
        last_seen = before["members"][owner]["last_seen"]
        while leader.generation == generation:
            assert time.time() < deadline, "never evicted"
            member = leader.topology()["members"].get(owner)
            if member is not None:
                last_seen = member["last_seen"]
            time.sleep(0.002)
        # the silence the sweeper saw: from the last heartbeat it got
        silence = time.time() - last_seen
        waited = time.perf_counter() - t_stop
        rest = [n for n in names if n != owner]
        deadline = time.time() + 30
        while any(workers[n]["agent"].assignment is None
                  or workers[n]["agent"].assignment.generation
                  != leader.generation for n in rest):
            assert time.time() < deadline, "survivors never re-ranked"
            time.sleep(0.005)
        topo = leader.topology()
        held = {n: workers[n]["agent"].assignment.rank for n in rest}
        evictions = {s["labels"].get("reason"): s["value"] for s in
                     leader.metrics.snapshot()["metrics"][
                         "app_fleet_evictions"]["series"]}
        floor = FLEET_HEARTBEAT_S * 3
        judge("g_eviction",
              _eviction_faults(topo, owner, held, evictions, silence, floor)
              + ([] if leader.generation == generation + 1 else
                 [f"generation {generation} -> {leader.generation}"]),
              _eviction_faults(before, owner, held, evictions, silence,
                               floor))
        t_epoch = time.time() - (time.perf_counter() - t_phase)
        out["evict_events"] = [
            (e["attrs"].get("evicted"), e.get("cause"),
             round(e["ts"] - t_epoch, 3))
            for e in leader.events.snapshot(kind="fleet.evict")]
        out["g"] = {"evicted": owner, "seconds_to_eviction": waited,
                    "silence_before_eviction_s": silence,
                    "generation": [generation, leader.generation],
                    "ranks": held, "evictions": evictions}
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for w in workers.values():
            w["engine"].stop()
        log.close()
        gc.callbacks.remove(gc_timer)
        # the agents stamped their fleet context on this process's log
        # records: the phases after this one are no fleet member
        clear_fleet_context()
    out["pauses"] = {"gc_collections": len(collections_s),
                     "gc_max_ms": max(collections_s, default=0.0) * 1e3,
                     "sweeper_stalls": leader.stall_count,
                     "sweeper_stall_max_s": leader.stall_max_s}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["failed_checks"] = failed
    out["planted"] = planted
    emit(out)
    del workers
    gc.collect()
    torch.cuda.empty_cache()
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(
            f"serve_fleet: failed checks {failed}, planted faults that "
            f"passed: {[k for k, v in planted.items() if not v]}")


def _http_traced(port: int, prompt: str, traceparent: str):
    """``POST /chat`` with a ``traceparent`` header: (status, headers with
    lower-case names, JSON body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/chat",
                     body=json.dumps({"prompt": prompt, "max_tokens": 8,
                                      "temperature": 0}),
                     headers={"Content-Type": "application/json",
                              "traceparent": traceparent})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                json.loads(resp.read()))
    finally:
        conn.close()


def phase_serve_spec(dev, smi_line: str) -> dict:
    """4 concurrent greedy ``POST /chat`` requests, 64 new tokens each,
    whose prompts repeat a short cycle of bytes (as ``bench.py``'s
    speculative scenario repeats a token cycle), through the plain
    engine ``app.serve_config`` gives, then through the speculative one
    (``speculative=True, spec_ngram=2``, the other spec knobs at the JAX
    engine's defaults: draft 4, branches 2, adaptive), then through the
    speculative one on an int8 pool (``kv_dtype="int8"``), same weights.
    The tree kernel's launch counter for the run's pool form is zeroed
    just before each run and read just after; in both speculative runs
    it must rise, and drafts must be made. Token agreement with the
    plain engine is printed, not required: a bf16 near-tie between the
    verify and decode kernels can flip an argmax (``model_spec`` prints
    the margins)."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.paged_attention import paged_tree_attention
    from gofr_tpu_torch.serving.app import (build_engine, build_server,
                                            serve_config)
    cfg = LlamaConfig.llama3_1b()
    prompts = _spec_prompts()
    runs = {}
    spec = {"speculative": True, "spec_ngram": 2}
    for name, overrides in (("plain", {}), ("spec", spec),
                            ("spec_int8", {**spec, "kv_dtype": "int8"})):
        counter = "launches_int8" if name == "spec_int8" else "launches"
        engine = build_engine(cfg, device=dev, seed=0,
                              engine_config=serve_config(cfg, **overrides))
        server = build_server(engine, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        engine.start()
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/chat"
        got: list = [None] * len(prompts)

        def ask(i):
            got[i] = _post(url, {"prompt": prompts[i], "max_tokens": 64,
                                 "temperature": 0})

        try:
            setattr(paged_tree_attention, counter, 0)
            t0 = time.perf_counter()
            workers = [threading.Thread(target=ask, args=(i,))
                       for i in range(len(prompts))]
            for wk in workers:
                wk.start()
            for wk in workers:
                wk.join(timeout=600)
            wall = time.perf_counter() - t0
            launches = getattr(paged_tree_attention, counter)
            stats = dict(engine.stats)
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
            thread.join(timeout=30)
        if any(a is None or a[0] != 201 for a in got):
            raise AssertionError(f"serve_spec {name}: not every answer was "
                                 f"201: {got}")
        tokens = [a[1]["data"]["tokens"] for a in got]
        if [len(t) for t in tokens] != [64] * len(prompts):
            raise AssertionError(f"serve_spec {name}: token counts "
                                 f"{[len(t) for t in tokens]} != 64 each")
        passes = stats["decode_passes"] + stats["spec_passes"]
        runs[name] = {
            "wall_s": wall, "tree_launches": launches,
            "spec_passes": stats["spec_passes"],
            "spec_drafted": stats["spec_drafted"],
            "spec_accepted": stats["spec_accepted"],
            "spec_rows": stats["spec_rows"],
            "decode_passes": stats["decode_passes"],
            "decode_tokens": stats["decode_tokens"],
            "tokens_per_pass": stats["decode_tokens"] / max(1, passes),
            "tokens_per_verify_row": ((stats["spec_accepted"]
                                       + stats["spec_rows"])
                                      / max(1, stats["spec_rows"])),
            "decode_s": stats["decode_s"], "spec_s": stats["spec_s"],
            "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
            **_graph_stats(stats),
            "ttft_ms": [a[1]["data"]["usage"]["ttft_ms"] for a in got],
            "tokens": tokens}
        del engine
        torch.cuda.empty_cache()
    plain = runs["plain"]
    emit({"phase": "serve_spec", "card": smi_line,
          "config": "app.serve_config + speculative=True spec_ngram=2 "
          "(draft 4, branches 2, adaptive); spec_int8: + kv_dtype=int8",
          "prompts": "4 x 300 bytes, each a short cycle repeated",
          **{f"{name}_common_prefix_with_plain": [
              _common_prefix(a, b)
              for a, b in zip(runs[name]["tokens"], plain["tokens"])]
             for name in ("spec", "spec_int8")},
          **{f"{name}_{key}": val for name, run in runs.items()
             for key, val in run.items() if key != "tokens"}})
    for name in ("spec", "spec_int8"):
        if runs[name]["tree_launches"] < 1 or runs[name]["spec_drafted"] < 1:
            raise AssertionError(
                f"serve_spec {name}: tree kernel launches "
                f"{runs[name]['tree_launches']}, drafted "
                f"{runs[name]['spec_drafted']}: the speculative path did "
                f"not run")
    return {"paged_tree_attention": runs["spec"]["tree_launches"],
            "paged_tree_attention_int8": runs["spec_int8"]["tree_launches"]}


def _prefill_host_ms(engine, prompts, scatter) -> dict:
    """One group prefill through ``engine._prefill_group`` with the
    module's ``scatter_chunk_kv`` set to ``scatter``: the host ms until the
    call returns (the launch) and until the card is done (CUDA
    synchronize), each the median of three after one warm-up; the
    requests are collected and retired after each call."""
    import torch
    from gofr_tpu_torch.serving import engine as engine_mod
    from gofr_tpu_torch.serving.engine import SamplingParams
    bucket = engine._bucket_for(max(len(p) for p in prompts))
    kept = engine_mod.scatter_chunk_kv
    engine_mod.scatter_chunk_kv = scatter
    host, done = [], []
    try:
        for _ in range(4):
            reqs = [engine.submit(p, SamplingParams(temperature=0.0,
                                                    max_new_tokens=4))
                    for p in prompts]
            group = engine.waiting.pop_batch(len(reqs), first_wait_s=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._prefill_group(bucket, group)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            done.append((time.perf_counter() - t0) * 1e3)
            engine._collect_prefills()
            for req in reqs:
                engine._retire(req.slot)
    finally:
        engine_mod.scatter_chunk_kv = kept
    return {"host_ms": statistics.median(host[1:]),
            "card_done_ms": statistics.median(done[1:])}


def _books(engine) -> bool:
    """Every page free or pinned by the prefix cache, one reference per
    cache entry listing it, no slot holding a page."""
    import numpy as np
    pinned = [p for pages in engine._prefix_cache.values() for p in pages]
    free = engine._free_pages
    return (len(free) == len(set(free))
            and len(free) + len(set(pinned)) == engine._n_pages
            and bool((engine._slot_pages == 0).all())
            and np.array_equal(engine._page_refs, np.bincount(
                pinned, minlength=engine._n_pages)))


def phase_serve_preempt(dev, smi_line: str) -> dict:
    """The engine's scheduling core at ``llama3_1b`` on ``serve_config``:
    8 greedy requests of 256 new tokens (prompts 6 x 301 then 2 x 901
    random tokens, seed 8), all queued before ``start()`` so that they
    share one admission batch, after ``engine.warmup(prompt_lens=(301,
    901))``. Runs: *ample* (the default pool, 256 pages) at
    ``pipeline_depth`` 0 and 1; *dry* (``kv_pages=64``, 128 MiB of bf16
    pool: the prompts take 6·5 + 2·15 = 60 pages, whole lives 92, so
    decode growth must preempt) at depth 0 and 1; *dry int8*
    (``kv_dtype="int8"`` at the dry pool's bytes, ~120 pages), which
    should preempt nothing. Checks per run: every request ends with 256
    tokens and no error; every first token (fresh or recomputed) comes
    from a prefill of the original prompt followed by every token the
    request had emitted (a wrapper on ``_first_token``); the pool's
    books balance afterwards; no graph is captured while serving; the
    flash, decode, fused write (``rope_kv_write``) and slab write
    (``scatter_chunk_kv``) counters, zeroed just before, rise, and the
    per-layer ``kv_write`` stays at 0;
    requests never preempted equal the tokens of the ample depth-0 run
    of their pool form (an *ample int8* run, the default int8 pool, is
    the int8 reference) bit for bit (decode rows are independent at a
    fixed ``max_batch`` shape, and the split count comes from shapes
    alone) and preempted ones do up to their first preemption (recorded
    by a wrapper on ``_preempt``); ample depth 1 equals depth 0; the dry
    bf16 runs preempt at least once; the dry int8 run preempts nothing. Then
    three planted faults on the dry pool must each fail a check: a
    ``_preempt`` that recomputes from the original prompt only, a
    ``_release_pages`` that skips preempted victims (their pages leak),
    and a dispatch that forgets which request each row decoded for (so
    a resync feeds a stale token while a pass is in flight). Before the
    runs: one 8 x 301-token group prefill's host-blocked ms with the
    sync-free ``scatter_chunk_kv`` and with ``scatter_chunk_kv_plain``
    (its ``keep_index`` sync, what the prefill did before). Printed per run:
    preemptions, requeues, decode tokens/s, ``dispatch_s``,
    ``collect_s``, each request's TTFT, launches, warmup seconds."""
    import numpy as np
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import (kv_write, rope_kv_write,
                                             scatter_chunk_kv,
                                             scatter_chunk_kv_plain)
    from gofr_tpu_torch.serving.app import serve_config
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    rng = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
               .tolist() for n in [301] * 6 + [901] * 2]
    n_new = 256
    greedy = SamplingParams(temperature=0.0, max_new_tokens=n_new)
    t0 = time.perf_counter()

    probe = llama_engine(params, cfg, serve_config(cfg), device=dev)
    prefill_ms = {}
    for name, fn in (("plain", scatter_chunk_kv_plain),
                     ("kernel", scatter_chunk_kv),
                     ("kernel_again", scatter_chunk_kv),
                     ("plain_again", scatter_chunk_kv_plain)):
        prefill_ms[name] = _prefill_host_ms(probe, prompts[:6] + prompts[:2],
                                            fn)
    del probe
    gc.collect()
    torch.cuda.empty_cache()

    def serve(name, plant=None, **overrides):
        engine = llama_engine(params, cfg, serve_config(cfg, **overrides),
                              device=dev)
        first_preempt: dict = {}
        bad_stream: list = []
        inner_preempt, inner_first = engine._preempt, engine._first_token

        def preempt(slot):
            req = engine.active[slot]
            if req is not None:
                first_preempt.setdefault(id(req), len(req.generated))
            inner_preempt(slot)

        def first_token(req, token):
            if req.prompt_tokens != original[id(req)] + req.generated:
                bad_stream.append(reqs.index(req))
            inner_first(req, token)

        engine._preempt, engine._first_token = preempt, first_token
        if plant is not None:
            plant(engine)
        warm_s = engine.warmup(prompt_lens=(301, 901))
        captures = engine._decode_graph.captures
        reqs = [engine.submit(p, greedy) for p in prompts]
        original = {id(r): list(r.prompt_tokens) for r in reqs}
        counters = [(flash_attention, "launches")] + [
            (fn, attr) for attr in ("launches", "launches_int8")
            for fn in (paged_chunk_attention, paged_decode_attention,
                       rope_kv_write, scatter_chunk_kv, kv_write)]
        for fn, attr in counters:
            setattr(fn, attr, 0)
        start = time.perf_counter()
        engine.start()
        progress, last = -1, time.perf_counter()
        try:
            while not all(r.done.is_set() for r in reqs):
                if engine.total_generated != progress:
                    progress, last = engine.total_generated, time.perf_counter()
                elif time.perf_counter() - last > 30:
                    break                    # stalled: fail what is left
                time.sleep(0.01)
            wall = time.perf_counter() - start
        finally:
            engine.stop()
        launches = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                    for fn, attr in counters}
        stats = engine.stats
        run = {"run": name, "kv_dtype": engine.config.kv_dtype,
               "pipeline_depth": engine.config.pipeline_depth,
               "pool_pages": engine._n_pages,
               "pool_bytes": _pool_bytes(engine), "wall_s": wall,
               "warmup_s": warm_s,
               "captures_while_serving": engine._decode_graph.captures
               - captures,
               "preemptions": stats["preemptions"],
               "requeues": stats["requeues"],
               "preempted_requests": sorted(
                   reqs.index(r) for r in reqs if id(r) in first_preempt),
               "first_preemption_at": [first_preempt.get(id(r))
                                       for r in reqs],
               "decode_tokens": stats["decode_tokens"],
               "decode_s": stats["decode_s"],
               "decode_tokens_per_s": stats["decode_tokens"]
               / stats["decode_s"],
               "dispatch_s": stats["dispatch_s"],
               "collect_s": stats["collect_s"],
               "decode_passes": stats["decode_passes"],
               "prefill_calls": stats["prefill_calls"],
               "prefill_s": stats["prefill_s"],
               "prefix_hits": stats["prefix_hits"],
               "prefix_evictions": stats["prefix_evictions"],
               "ttft_ms": [r.ttft_ms for r in reqs],
               "errors": [r.error for r in reqs if r.error],
               "n_tokens": [len(r.generated) for r in reqs],
               "stream_faults": bad_stream, "books_balance": _books(engine),
               "launches": launches}
        tokens = [list(r.generated) for r in reqs]
        del engine, reqs
        gc.collect()
        torch.cuda.empty_cache()
        return run, tokens

    def failed_checks(run, tokens, ample):
        suffix = "_int8" if run["kv_dtype"] == "int8" else ""
        out = []
        if run["errors"] or run["n_tokens"] != [n_new] * len(prompts):
            out.append("complete")
        if run["stream_faults"]:
            out.append("recompute_prompt")
        if not run["books_balance"]:
            out.append("books")
        if run["captures_while_serving"]:
            out.append("no_capture_while_serving")
        if min(run["launches"][k] for k in (
                "flash_attention.launches",
                f"paged_decode_attention.launches{suffix}",
                f"rope_kv_write.launches{suffix}",
                f"scatter_chunk_kv.launches{suffix}")) < 1:
            out.append("launches")
        if run["launches"]["kv_write.launches"] \
                or run["launches"]["kv_write.launches_int8"]:
            out.append("per_layer_write_off_path")
        if ample is not None:
            for i, (got, want) in enumerate(zip(tokens, ample)):
                n = run["first_preemption_at"][i]
                if n is None:
                    n = len(want)            # never preempted: every token
                if got[:n] != want[:n]:
                    out.append(f"tokens_{i}")
        return out

    runs, toks = {}, {}
    for name, overrides in (
            ("ample_d0", {"pipeline_depth": 0}),
            ("ample_d1", {"pipeline_depth": 1}),
            ("dry_d0", {"pipeline_depth": 0, "kv_pages": 64}),
            ("dry_d1", {"pipeline_depth": 1, "kv_pages": 64})):
        runs[name], toks[name] = serve(name, **overrides)
    runs["ample_int8"], toks["ample_int8"] = serve(
        "ample_int8", pipeline_depth=0, kv_dtype="int8")
    dry_bytes = runs["dry_d0"]["pool_bytes"]
    runs["dry_int8"], toks["dry_int8"] = serve(
        "dry_int8", pipeline_depth=0, kv_dtype="int8",
        kv_pool_bytes=dry_bytes)
    # each run against the ample depth-0 run of its pool form
    refs = {"bf16": "ample_d0", "int8": "ample_int8"}
    failed = {name: failed_checks(run, toks[name], None
                                  if name == refs[run["kv_dtype"]]
                                  else toks[refs[run["kv_dtype"]]])
              for name, run in runs.items()}
    for name in ("dry_d0", "dry_d1"):
        if runs[name]["preemptions"] < 1:
            failed[name].append("preempted")
    if runs["dry_int8"]["preemptions"]:
        failed["dry_int8"].append("int8_preempts_nothing")

    def prompt_only(engine):
        inner = engine._preempt

        def preempt(slot):
            req = engine.active[slot]
            inner(slot)
            if req is not None:
                req.prompt_tokens = req.prompt_tokens[
                    :len(req.prompt_tokens) - len(req.generated)]
        engine._preempt = preempt

    def leak_victims(engine):
        inner = engine._preempt

        def forget(slot):        # the table forgets, the references stay
            engine._tables[slot, :] = engine._n_pages
            engine._slot_pages[slot] = 0

        def preempt(slot):
            engine._release_pages = forget
            try:
                inner(slot)
            finally:
                del engine._release_pages
        engine._preempt = preempt

    def stale_feed(engine):
        inner = engine._decode_dispatch

        def dispatch():
            inner()
            engine._dev_last_reqs = [None] * engine.config.max_batch
        engine._decode_dispatch = dispatch

    planted = {}
    for name, plant in (("preempt_recomputes_original_prompt", prompt_only),
                        ("release_pages_skips_victims", leak_victims),
                        ("dispatch_forgets_device_tokens", stale_feed)):
        run, tokens = serve(name, plant, pipeline_depth=1, kv_pages=64)
        planted[name] = {"failed_checks": failed_checks(
            run, tokens, toks["ample_d0"]), "preemptions": run["preemptions"],
            "n_tokens": run["n_tokens"], "books_balance": run["books_balance"]}
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_preempt", "card": smi_line,
          "config": "llama3_1b bf16 random seed 0, app.serve_config, "
          "8 greedy requests (6 x 301 + 2 x 901 prompt tokens, seed 8), "
          "256 new tokens each, queued before start(), warmup(prompt_lens="
          "(301, 901))",
          "prefill_group_8x301_ms": prefill_ms,
          "tokens_per_s_depth1_over_depth0_ample":
              runs["ample_d1"]["decode_tokens_per_s"]
              / runs["ample_d0"]["decode_tokens_per_s"],
          "int8_vs_bf16_dry": {
              "pages": [runs["dry_int8"]["pool_pages"],
                        runs["dry_d0"]["pool_pages"]],
              "preemptions": [runs["dry_int8"]["preemptions"],
                              runs["dry_d0"]["preemptions"]]},
          "failed_checks": failed, "planted": planted,
          "seconds": time.perf_counter() - t0})
    for run in runs.values():
        emit({"phase": "serve_preempt_run", "card": smi_line, **run})
    bad = {name: f for name, f in failed.items() if f}
    if bad:
        raise AssertionError(f"serve_preempt: checks failed: {bad}")
    missed = [name for name, p in planted.items() if not p["failed_checks"]]
    if missed:
        raise AssertionError(f"serve_preempt: planted faults passed every "
                             f"check: {missed}")
    launches = {}
    for run in runs.values():
        for key, n in run["launches"].items():
            launches[key] = launches.get(key, 0) + n
    return launches


def _moe_waves() -> list:
    """serve_moe's waves: serve's wave 1 (4 prompts, one a bucket), the
    1801-token prompt (clamped to the widest bucket: the family has no
    chunk walk), a 101-token prompt alone (it decodes inside the 512-row
    window) and a 1001-token prompt: one letter 512 times, then seeded
    random letters. A random model's attention averages the values of
    its rows, and over the repeated phrases of the other prompts any
    window's average looks alike; over this one a 512-row window sees
    one row's value, the whole prompt another average."""
    import random
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")
    rng = random.Random(7)
    letters = "a" * 511 + "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ")
                                  for _ in range(489))
    return [[(words * 20)[:n] for n in (20, 150, 400, 900)],
            [(story * 30)[:1800]], [(story * 2)[:100]], [letters]]


MOE_WAVES = _moe_waves()
MOE_NEW = 32
MOE_WINDOWS = (512, 1024)


def _serve_run(params, cfg, dev, smi_line, name, waves=MOE_WAVES,
               engine=None, *, build=None, phase: str = "serve_moe",
               n_new=MOE_NEW, counters: dict | None = None,
               **overrides) -> dict:
    """Serve ``waves`` (each one concurrent batch of greedy ``POST
    /chat``, ``n_new`` new tokens each: one count, or one per wave)
    through the app over ``build(params, cfg, engine_config,
    device=dev)`` (default ``moe_engine``) on ``serve_config`` +
    ``overrides``, warmed up first (its decode graphs captured); or
    through ``engine`` when given (already warm, left running for the
    caller to stop). ``counters``: name -> (kernel wrapper, counter
    attribute), zeroed before the first wave and read after the last
    (default: the flash kernel's and the slab write's). Returns the
    answers, the counters, the engine's stats, the dispatch records of
    the run and its engine; prints one ``phase`` line."""
    import torch
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk_kv
    from gofr_tpu_torch.serving.app import build_server, serve_config
    from gofr_tpu_torch.serving.glue import moe_engine
    t0 = time.perf_counter()
    own = engine is None
    warmup_s = None
    if own:
        engine = (build or moe_engine)(params, cfg, serve_config(
            cfg, autoprof=False, **overrides), device=dev)
        warmup_s = engine.warmup()
    captures_warm = engine.stats["graph_captures"]
    before = engine.recorder.snapshot()
    seq0, requests0 = before["passes_recorded"], len(before["requests"])
    server = build_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    counters = counters or {
        "flash_attention": (flash_attention, "launches"),
        "scatter_chunk_kv": (scatter_chunk_kv, "launches"),
        "scatter_chunk_kv_int8": (scatter_chunk_kv, "launches_int8")}
    news = n_new if isinstance(n_new, list) else [n_new] * len(waves)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    windows0 = dict(engine._decode_graph.passes_by_window)
    engine.start()
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/chat"
    answers: list = []
    walls = []

    def ask(prompt, out, i, new):
        try:
            out[i] = _post(url, {"prompt": prompt, "max_tokens": new,
                                 "temperature": 0})
        except urllib.error.HTTPError as exc:     # a typed refusal
            out[i] = (exc.code, {})

    try:
        for wave, new in zip(waves, news):
            got: list = [None] * len(wave)
            w0 = time.perf_counter()
            workers = [threading.Thread(target=ask, args=(p, got, i, new))
                       for i, p in enumerate(wave)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            walls.append(time.perf_counter() - w0)
            answers += got
        torch.cuda.synchronize()
        launches = {k: getattr(fn, attr) for k, (fn, attr)
                    in counters.items()}
        stats = dict(engine.stats)
        after = engine.recorder.snapshot()
        passes = [p for p in after["passes"] if p["seq"] > seq0]
        served = [r["prompt_tokens"] for r in after["requests"][requests0:]]
    finally:
        server.shutdown()
        server.server_close()
        if own:
            engine.stop()
        thread.join(timeout=30)
    ok = [a is not None and a[0] == 201 for a in answers]
    usage = [a[1]["data"]["usage"] if good else None
             for a, good in zip(answers, ok)]
    tokens = [a[1]["data"]["tokens"] if good else None
              for a, good in zip(answers, ok)]
    windows = {str(w): n - windows0.get(w, 0) for w, n in
               engine._decode_graph.passes_by_window.items()}
    out = {"phase": phase, "run": name, "card": smi_line,
           "config": {k: overrides[k] for k in sorted(overrides)},
           "answers_201": sum(ok), "requests": len(answers),
           "prompt_tokens": [u and u["prompt_tokens"] for u in usage],
           "engine_prompt_tokens": sorted(served),
           "completion_tokens": [t and len(t) for t in tokens],
           "ttft_ms": [u and u["ttft_ms"] for u in usage],
           "wall_s_per_wave": walls,
           "decode_tokens_per_s": (stats["decode_tokens"]
                                   / max(stats["decode_s"], 1e-9)),
           "decode_passes": stats["decode_passes"],
           **{k: stats[k] for k in ("prefix_hits", "prefill_calls",
                                    "spec_passes", "spec_drafted",
                                    "spec_accepted")},
           "passes_by_window": windows, "warmup_s": warmup_s,
           "graph_captures_after_warmup": captures_warm,
           "graph_captures": stats["graph_captures"],
           "sched_syncs": stats["sched_syncs"],
           "h2d_transfers": stats["h2d_transfers"],
           "launches": launches, "run_wall_s": time.perf_counter() - t0}
    emit(out)
    return {**out, "tokens": tokens, "passes": passes, "engine": engine,
            "prompts": [p for wave in waves for p in wave],
            "n_new": [new for wave, new in zip(waves, news) for _ in wave]}


def _same_tokens(run, ref, answers=None) -> list:
    """[] when ``run`` gave ``ref``'s tokens (those of ``ref``'s answers
    at the indices ``answers``, the waves ``run`` served; None: all),
    else where they differ."""
    got = run["tokens"]
    want = ref["tokens"] if answers is None else [ref["tokens"][i]
                                                  for i in answers]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        return [f"tokens differ from {ref['run']} at answers {bad}"]
    return []


def _complete_faults(run) -> list:
    """Every answer 201 with 32 tokens; the 1801-token prompt (counted
    1801 by the tokenizer, in the answer's usage) served as its last
    1024 tokens: the widest bucket."""
    out = []
    if run["answers_201"] != run["requests"]:
        out.append(f"{run['requests'] - run['answers_201']} answers not 201")
    elif run["completion_tokens"] != [MOE_NEW] * run["requests"]:
        out.append(f"completion tokens {run['completion_tokens']}")
    if 1801 in run["prompt_tokens"] and (
            max(run["engine_prompt_tokens"]) != 1024):
        out.append(f"the engine served prompts of "
                   f"{run['engine_prompt_tokens']} tokens: the 1801-token "
                   f"one was not clamped to the widest bucket's 1024")
    return out


def _window_faults(run, ref) -> list:
    """(b) the windowed run's tokens are the full graph's, and its 512,
    1024 and full graphs were each replayed."""
    out = _same_tokens(run, ref)
    used = run["passes_by_window"]
    if not all(used.get(str(w), 0) > 0 for w in (*MOE_WINDOWS, 0)):
        out.append(f"not every window graph was replayed: {used}")
    return out


def _int8_faults(run) -> list:
    """(c) the int8 pool completes every request, and its prefill and
    write-back went through the slab kernel's int8 entry only."""
    out = _complete_faults(run)
    if run["launches"]["scatter_chunk_kv_int8"] < 1 or \
            run["launches"]["scatter_chunk_kv"]:
        out.append(f"slab launches {run['launches']}: the int8 counter "
                   f"must rise, the bf16 one stay 0")
    return out


def _graph_faults(run, n_windows: int, paged: bool) -> list:
    """(e) one captured graph per window and the full one, for greedy
    and sampled batches, all in warmup; none while serving; and no state
    upload in a steady-state dispatch: a decode pass whose occupancy is
    the previous decode pass's, with no prefill collected between. On the
    paged layout such a pass may carry one table upload (a slot's table
    grew a page, an event of its own); a state sync is 7 uploads."""
    out = []
    want = 2 * (1 + n_windows)
    if run["graph_captures_after_warmup"] != want:
        out.append(f"{run['graph_captures_after_warmup']} graphs captured "
                   f"in warmup, not {want}")
    if run["graph_captures"] != run["graph_captures_after_warmup"]:
        out.append(f"{run['graph_captures'] - run['graph_captures_after_warmup']}"
                   f" captures while serving")
    steady, uploads, last = 0, [], None
    for rec in run["passes"]:
        if rec.get("kind") != "decode":
            last = None
            continue
        if last is not None and rec.get("occupancy") == last:
            steady += 1
            if rec.get("h2d", 0) > (1 if paged else 0):
                uploads.append(rec["h2d"])
        last = rec.get("occupancy")
    run["steady_passes"], run["steady_uploads"] = steady, uploads
    if not steady or uploads:
        out.append(f"{steady} steady-state dispatches, uploads {uploads}")
    return out


def _moe_restart(engine, params, cfg, dev, smi_line, name: str) -> list:
    """(f) a restart on the slot layout (``pass_raise`` at the loop's
    third turn, a restart policy, the 101-token wave served through it,
    then once more after it) keeps the captured graphs and the device
    memory: ``graph_captures``, ``torch.cuda.memory_allocated()`` and the
    caches' addresses equal before and after, one restart, the wave
    after it answered 201. Returns the faults found."""
    import torch
    from gofr_tpu_torch.serving.engine import RestartPolicy
    from gofr_tpu_torch.serving.faults import FaultPlan
    engine.faults = FaultPlan.parse("pass_raise:at=3")
    engine.faults.events = engine.events
    engine.config.restart_policy = RestartPolicy(backoff_s=0.01)
    engine._restarts = 0
    if name.startswith("planted"):
        # the fault the check is for: a restart that reallocates the
        # caches (as JAX's does when a donated pass consumed them), so
        # the captured graphs no longer hold them
        reset = engine._reset_runtime_state

        def reallocating():
            reset()
            engine.k_cache = engine.k_cache.clone()
            engine.v_cache = engine.v_cache.clone()

        engine._reset_runtime_state = reallocating

    def state():
        torch.cuda.synchronize()
        return {"graph_captures": engine._decode_graph.captures,
                "memory_allocated": torch.cuda.memory_allocated(),
                "caches": [engine.k_cache.data_ptr(),
                           engine.v_cache.data_ptr()]}

    before = state()
    engine.waiting.reopen()
    run = _serve_run(params, cfg, dev, smi_line, name,
                   waves=MOE_WAVES[2:3] * 2, engine=engine)
    engine.stop()
    after = state()
    emit({"phase": "serve_moe", "run": name, "card": smi_line,
          "restarts": engine._restarts, "before": before, "after": after,
          "answers_201": run["answers_201"]})
    out = [f"{k}: {before[k]} -> {after[k]}" for k in before
           if before[k] != after[k]]
    if engine._restarts != 1:
        out.append(f"{engine._restarts} restarts, not 1")
    if run["completion_tokens"][-1] != MOE_NEW:
        out.append("the wave after the restart was not answered")
    return out


def _moe_split(engine, params, cfg, dev) -> dict:
    """One decode step's device ms on the slot layout's caches (8 slots
    at lengths up to 2000), and the part of it spent in the MoE MLP: the
    eight layers' ``_moe_mlp`` (the ffn norm, the router, every expert's
    float32 products and the combine) on [8, 1, 4096] rows."""
    import torch
    from gofr_tpu_torch.models.llama import _layer
    from gofr_tpu_torch.models.moe import _moe_mlp, moe_decode_step
    b = 8
    tokens = torch.arange(1, b + 1, device=dev)
    lengths = torch.tensor([21, 151, 401, 901, 1000, 1500, 1999, 64],
                           dtype=torch.int32, device=dev)
    x = torch.randn(b, 1, cfg.dim, device=dev).bfloat16()
    layers = [_layer(params, li) for li in range(cfg.n_layers)]

    def step():
        moe_decode_step(params, tokens, engine.k_cache, engine.v_cache,
                        lengths, cfg)

    def moe_mlps():
        for lp in layers:
            _moe_mlp(x, lp, cfg)

    total = device_ms(step, warmup=1, iters=5)
    mlp = device_ms(moe_mlps, warmup=1, iters=5)
    # the MoE MLP's kernels by device ms, one pass over the 8 layers
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        moe_mlps()
        torch.cuda.synchronize()
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:80]
            by_kernel[name] = by_kernel.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    return {"decode_step_device_ms": total,
            "moe_mlp_device_ms": mlp,
            "rest_device_ms": total - mlp,
            "moe_mlp_share": mlp / total,
            "moe_mlp_kernels_ms": dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:6]),
            "decode_step_ms": time_ms(step, warmup=1, iters=5)}


def _view_split(engine, dev) -> dict:
    """The dense view's gather (K and V) and write-back device ms per
    decode dispatch, at the full 2048-row view of 8 slots."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import gather_view, scatter_decode_kv
    tables = torch.arange(8 * 32, dtype=torch.int32,
                          device=dev).reshape(8, 32) % engine._n_pages
    lengths = torch.tensor([21, 151, 401, 901, 1000, 1500, 1999, 64],
                           dtype=torch.int32, device=dev)
    kp, vp = engine.k_cache, engine.v_cache
    dtype = engine._view_dtype
    views = [gather_view(kp, tables, dtype), gather_view(vp, tables, dtype)]
    steps = engine._tokens_per_pass
    return {"view_gather_device_ms": device_ms(
                lambda: (gather_view(kp, tables, dtype),
                         gather_view(vp, tables, dtype)), warmup=1, iters=5),
            "view_scatter_device_ms": device_ms(
                lambda: scatter_decode_kv(kp, vp, tables, *views, lengths,
                                          steps), warmup=1, iters=5)}


def phase_serve_moe(dev, smi_line: str, cfg=None) -> dict:
    """The Mixtral-style MoE family on the engine's dense-cache paths:
    ``MoEConfig.mixtral_8x7b()`` at 8 of its 32 layers (32 layers are
    93.4 GB of bf16 weights, above the card's 80 GB), random bf16
    weights from seed 0, served by ``build_server(moe_engine(...))`` on
    ``serve_config`` (8 slots, max_seq 2048, 64-row pages, buckets to
    1024; the autoprofiler off), each engine warmed up first. Runs: the
    slot layout; the paged layout through the view, bf16 pool; the
    paged layout with an int8 pool and decode windows (512, 1024); the
    slot layout with those windows. Each serves ``MOE_WAVES``: wave 1 (4
    concurrent prompts of 21 / 151 / 401 / 901 tokens), the 1801-token
    prompt (clamped to 1024 tokens), a 101-token one and a 1001-token one
    of one letter and random ones, 32 new tokens each. Checks, each with a planted
    fault that must fail it:

    (a) slot and bf16 view give bit-equal tokens (plant: a view engine
        whose write-back lands one row late);
    (b) the windowed slot run gives the full graph's tokens and replays
        each window graph (plant: the dispatch forced to the 512 window
        for the 1001-token prompt);
    (c) the int8 pool completes every request through the slab kernel's
        int8 entry (plant: the bf16 view run's counters);
    (d) ``moe_prefill_last`` logits with the flash kernel within
        LOGITS_TOL of ``implementation="plain"`` (P = 2, S = 1024,
        kv_lengths 1024 / 901; plant: V rows read one late);
    (e) 2 x (windows + 1) graphs captured in warmup and none while
        serving, and no state upload in a steady-state dispatch (plant:
        the scheduler state marked dirty before every dispatch);
    (f) a ``pass_raise`` restart on the slot layout leaves
        ``graph_captures``, ``torch.cuda.memory_allocated()`` and the
        caches' addresses as they were (plant: a restart that
        reallocates the caches, which the captured graphs then refuse).

    Prints TTFT and decode tokens/s per run, a decode step's device ms
    split into the MoE MLP and the rest, the view's gather and
    write-back device ms per dispatch, ``max_memory_allocated`` and the
    phase's wall. Returns the launches of the D = 128 kernel rows: the
    flash kernel's and the slab kernel's (both forms) over the four
    runs. ``cfg`` replaces the model (a CPU rehearsal: ``MoEConfig.tiny()
    .scaled(vocab_size=260, max_seq=2048)``)."""
    from unittest import mock

    import torch
    from gofr_tpu_torch.models.moe import MoEConfig, moe_init, moe_prefill_last
    from gofr_tpu_torch.ops import flash_attention as flash_module
    from gofr_tpu_torch.ops.quant import quantized_bytes
    from gofr_tpu_torch.serving import decode_graph as graph_module
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or MoEConfig.mixtral_8x7b().scaled(n_layers=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = moe_init(cfg, gen, dev)
    torch.cuda.synchronize()
    weight_bytes = quantized_bytes(params)
    init_s = time.perf_counter() - t_phase

    # (d) the flash kernel at D = 128 inside the model, against plain
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                           device=dev)
    lens = torch.tensor([1024, 901], dtype=torch.int32, device=dev)
    real_flash = flash_module.flash_attention

    def v_late(q, k, v, **kw):
        return real_flash(q, k, torch.roll(v, 1, dims=1), **kw)

    # the wrapper counts on its module's name, which the patch rebinds
    v_late.launches = 0

    logits = {impl: moe_prefill_last(params, tokens, cfg, kv_lengths=lens,
                                     implementation=impl)[0]
              for impl in ("auto", "plain")}
    with mock.patch.object(flash_module, "flash_attention", v_late):
        fault_logits = moe_prefill_last(params, tokens, cfg,
                                        kv_lengths=lens)[0]
    logit_err = (logits["auto"] - logits["plain"]).abs().max().item()
    fault_err = (fault_logits - logits["plain"]).abs().max().item()
    finite = bool(torch.isfinite(logits["auto"]).all())
    del logits, fault_logits

    def logit_faults(err):
        return [] if finite and err <= LOGITS_TOL else \
            [f"logits diff {err} > {LOGITS_TOL} (finite {finite})"]

    runs = {"slot": _serve_run(params, cfg, dev, smi_line, "slot",
                             kv_layout="slot")}
    runs["slot"].update(_moe_split(runs["slot"]["engine"], params, cfg, dev))
    # (e)'s plant on the same engine: every dispatch re-uploads its state
    engine = runs["slot"]["engine"]
    dispatch = engine._decode_dispatch

    def always_dirty():
        engine._sched_dirty = True
        dispatch()

    engine._decode_dispatch = always_dirty
    engine.waiting.reopen()
    dirty = _serve_run(params, cfg, dev, smi_line, "planted_always_dirty",
                     waves=MOE_WAVES[:1], engine=engine)
    engine.stop()
    del engine._decode_dispatch
    # (f) on the same engine, then its plant: the caches reallocated
    restart = [_moe_restart(engine, params, cfg, dev, smi_line, name)
               for name in ("restart", "planted_caches_reallocated")]
    runs["view_bf16"] = _serve_run(params, cfg, dev, smi_line, "view_bf16",
                                 kv_layout="paged")
    split = _view_split(runs["view_bf16"]["engine"], dev)
    runs["view_int8"] = _serve_run(params, cfg, dev, smi_line, "view_int8",
                                 kv_layout="paged", kv_dtype="int8",
                                 decode_windows=MOE_WINDOWS)
    runs["slot_windows"] = _serve_run(params, cfg, dev, smi_line,
                                    "slot_windows", kv_layout="slot",
                                    decode_windows=MOE_WINDOWS)
    # (b)'s plant on the same engine: the narrowest window, always
    engine = runs["slot_windows"]["engine"]
    engine._pick_window = lambda needed: MOE_WINDOWS[0]
    engine.waiting.reopen()
    narrow = _serve_run(params, cfg, dev, smi_line, "planted_narrow_window",
                      waves=MOE_WAVES[3:], engine=engine)
    engine.stop()
    for run in runs.values():
        run.pop("engine")
    narrow.pop("engine"), dirty.pop("engine")
    gc.collect()
    torch.cuda.empty_cache()
    # (a)'s plant: the view's write-back one row late, in a fresh engine
    real_back = graph_module.scatter_decode_kv

    def back_late(k_pool, v_pool, tables, k_view, v_view, lengths, steps):
        return real_back(k_pool, v_pool, tables, k_view, v_view,
                         lengths + 1, steps)

    with mock.patch.object(graph_module, "scatter_decode_kv", back_late):
        late = _serve_run(params, cfg, dev, smi_line, "planted_late_writeback",
                        waves=MOE_WAVES[:1] + MOE_WAVES[3:],
                        kv_layout="paged")
    late.pop("engine")
    gc.collect()
    torch.cuda.empty_cache()

    slot, view = runs["slot"], runs["view_bf16"]
    # every run prefills through the flash kernel, and the bf16 view
    # writes through the slab kernel's bf16 entry
    launch_faults = [f"{name}: no flash launch" for name, run in runs.items()
                     if run["launches"]["flash_attention"] < 1]
    if view["launches"]["scatter_chunk_kv"] < 1:
        launch_faults.append(f"view_bf16: slab launches {view['launches']}")
    checks = {
        "a_slot_equals_view": (_same_tokens(view, slot)
                               + _complete_faults(slot)
                               + _complete_faults(view) + launch_faults,
                               _same_tokens(late, slot, [0, 1, 2, 3, 6])),
        "b_windows": (_window_faults(runs["slot_windows"], slot)
                      + _complete_faults(runs["slot_windows"]),
                      _same_tokens(narrow, slot, [6])),
        "c_int8": (_int8_faults(runs["view_int8"]), _int8_faults(view)),
        "d_logits": (logit_faults(logit_err), logit_faults(fault_err)),
        "e_graphs": ([f"{name}: {f}" for name, run in runs.items() for f in
                      _graph_faults(run, len(run["config"].get(
                          "decode_windows", ())),
                          run["config"]["kv_layout"] == "paged")],
                     _graph_faults(dirty, 0, False)),
        "f_restart": tuple(restart),
    }
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    launches = {key: sum(run["launches"][key] for run in runs.values())
                for key in slot["launches"]}
    summary = {
        "phase": "serve_moe", "card": smi_line,
        "config": f"mixtral_8x7b, n_layers {cfg.n_layers} of 32, bf16, "
                  "random seed 0",
        "weight_bytes": weight_bytes, "init_s": init_s,
        "logits_max_abs_diff": logit_err, "tolerance": LOGITS_TOL,
        "planted_fault_logits_diff": fault_err,
        "ttft_ms": {k: r["ttft_ms"] for k, r in runs.items()},
        "decode_tokens_per_s": {k: r["decode_tokens_per_s"]
                                for k, r in runs.items()},
        "steady_passes": {k: r.get("steady_passes") for k, r in runs.items()},
        **{k: slot[k] for k in ("decode_step_device_ms",
                                "moe_mlp_device_ms", "rest_device_ms",
                                "moe_mlp_share", "moe_mlp_kernels_ms",
                                "decode_step_ms")},
        **split, "launches": launches,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "phase_wall_s": time.perf_counter() - t_phase,
        "failed_checks": failed, "planted": planted}
    emit(summary)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_moe: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------------- serve_llama8b
def _serve_waves() -> list:
    """serve's three waves: 4 prompts of 20 / 150 / 400 / 900 bytes, one
    of 1800 (wider than every bucket: it walks), and three that share a
    page-aligned prefix with a wave-1 prompt or the long one (prefix
    hits on a layout with a prefix cache)."""
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")
    long_prompt = (story * 30)[:1800]
    return [[(words * 20)[:n] for n in (20, 150, 400, 900)], [long_prompt],
            [(words * 20)[:900] + " but the question at the end is new",
             (words * 20)[:400] + " and this ending differs",
             long_prompt[:1795] + " until a new ending"]]


def _spec_prompts() -> list:
    """serve_spec's 4 prompts: 300 bytes each, a short cycle repeated."""
    cycles = ["the cat sat on the mat. ", "one two three four five six. ",
              "abcd efgh abcd efgh ijkl ", "spec decode drafts from the "
              "prompt; "]
    return [(c * 40)[:300] for c in cycles]


LLAMA8B_NEW = 32
LLAMA8B_SPEC_NEW = 64
LLAMA8B_WINDOWS = (512, 1024)
#: Llama-3-8B's weights in bf16: 8,030,261,248 parameters, 2 bytes each
LLAMA8B_BYTES = 16_060_522_496
#: the spec wave's answers in a run that serves all four waves
SPEC_ANSWERS = [8, 9, 10, 11]


def _llama8b_counters() -> dict:
    """The launch counters of every kernel Llama's serving path runs:
    flash, and in both pool forms the paged decode, chunk and tree
    kernels, the fused RoPE + K/V write and the slab write."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention,
                                                    paged_tree_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write, scatter_chunk_kv
    out = {"flash_attention": (flash_attention, "launches")}
    for fn in (paged_decode_attention, paged_chunk_attention,
               paged_tree_attention, rope_kv_write, scatter_chunk_kv):
        for form in ("", "_int8"):
            out[fn.__name__ + form] = (fn, "launches" + form)
    return out


def _equal_faults(run, ref, answers) -> list:
    """[] when ``run``'s answers are ``ref``'s at the indices ``answers``
    bit for bit, else where not."""
    bad = [i for i in answers if run["tokens"][i] != ref["tokens"][i]]
    return [f"{run['run']} differs from {ref['run']} at answers {bad}"] \
        if bad else []


def _greedy_faults(run, params, cfg, dev,
                   implementation: str = "auto") -> tuple[list, dict]:
    """([] or the faults, a summary): each answer of ``run`` is a greedy
    answer of the model as the flash prefill reads it (or, with
    ``implementation="plain"``, as the plain path reads it): its prompt
    (text, or token ids) and tokens through ``llama_prefill`` in one
    pass, every token's logit within LOGITS_TOL of the largest at its
    position (the paths differ by rounding inside attention, so a
    near-tie may go either way; a fault moves logits further). The
    summary: per answer the worst margin and the tokens that are the
    argmax."""
    import torch
    from gofr_tpu_torch.models.llama import llama_prefill
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    encode = ByteTokenizer().encode
    faults, worst, argmax = [], [], []
    for i, (prompt, tokens) in enumerate(zip(run["prompts"], run["tokens"])):
        if not tokens:
            faults.append(f"{run['run']} answer {i}: no tokens")
            continue
        ids = list(prompt) if isinstance(prompt, list) else encode(prompt)
        seq = torch.tensor([ids + tokens], device=dev)
        logits, _ = llama_prefill(params, seq, cfg,
                                  implementation=implementation)
        at = logits[0, len(ids) - 1:len(ids) - 1 + len(tokens)]
        picked = at.gather(1, torch.tensor(tokens, device=dev)[:, None])
        margin = (at.amax(1, keepdim=True) - picked)[:, 0]
        worst.append(margin.max().item())
        argmax.append(int((margin == 0).sum()))
        del logits, at
        if worst[-1] > LOGITS_TOL:
            faults.append(f"{run['run']} answer {i}: token "
                          f"{int(margin.argmax())} is {worst[-1]} below the "
                          f"largest logit (> {LOGITS_TOL})")
    return faults, {"worst_margin": worst, "argmax_tokens": argmax,
                    "tokens": [len(t or ()) for t in run["tokens"]]}


def _served_faults(run) -> list:
    """Every answer 201 with its wave's count of new tokens."""
    if run["answers_201"] != run["requests"]:
        return [f"{run['run']}: {run['requests'] - run['answers_201']} "
                f"answers not 201"]
    if run["completion_tokens"] != run["n_new"]:
        return [f"{run['run']}: completion tokens {run['completion_tokens']}"]
    return []


def _walk_faults(run) -> list:
    """The 1801-token prompt (1800 bytes and bos) served whole: its
    answer's usage and the engine's request log both count 1801."""
    if 1801 in run["prompt_tokens"] and 1801 in run["engine_prompt_tokens"]:
        return []
    return [f"{run['run']}: prompts served as {run['engine_prompt_tokens']} "
            f"tokens: the 1801-token one was not walked whole"]


def _capture_faults(run) -> list:
    """Graphs captured in warmup and none while serving."""
    warm, total = run["graph_captures_after_warmup"], run["graph_captures"]
    if warm and total == warm:
        return []
    return [f"{run['run']}: {warm} graphs in warmup, {total - warm} captured "
            f"while serving"]


def _kernel_split(step) -> dict:
    """Device ms of one call of ``step`` by kernel kind, from one
    ``torch.profiler`` trace: cuBLAS / CUTLASS GEMMs, the paged attention
    kernels, the RoPE + K/V write kernel, and the rest; kernel counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kinds: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("gemm" if any(t in name for t in ("gemm", "gemv", "nvjet",
                                                   "cutlass", "xmma"))
                else "attention" if any(t in name for t in (
                    "paged_decode", "paged_chunk", "flash_fwd"))
                else "kv_write" if "kv_write" in name else "rest")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                       n + 1)
    return {k: {"device_ms": ms, "kernels": n}
            for k, (ms, n) in sorted(kinds.items())}


def _llama8b_step(engine, params, cfg, dev, paged: bool) -> dict:
    """One decode step's device ms (and ms by CUDA events) on the
    engine's caches, 8 slots at lengths 21-1999: natively through the
    pool (tables of 32 pages a slot) or on the slot caches; and its
    device ms by kernel kind."""
    import torch
    from gofr_tpu_torch.models.llama import (llama_decode_step,
                                             llama_decode_step_paged)
    b = 8
    tokens = torch.arange(1, b + 1, device=dev)
    lengths = torch.tensor([21, 151, 401, 901, 1000, 1500, 1999, 64],
                           dtype=torch.int32, device=dev)
    if paged:
        tables = torch.arange(b * 32, dtype=torch.int32,
                              device=dev).reshape(b, 32) % engine._n_pages

        def step():
            llama_decode_step_paged(params, tokens, engine.k_cache,
                                    engine.v_cache, tables, lengths, cfg)
    else:
        def step():
            llama_decode_step(params, tokens, engine.k_cache,
                              engine.v_cache, lengths, cfg)
    return {"decode_step_device_ms": device_ms(step, warmup=1, iters=5),
            "decode_step_ms": time_ms(step, warmup=1, iters=5),
            "decode_step_by_kind": _kernel_split(step)}


def _llama8b_logits(params, cfg, dev) -> dict:
    """(e) one decode step and one chunk call at the model's width
    through the kernels and through the plain versions (``implementation
    ="plain"``), each on its own copy of one pool: 4 slots prefilled
    through flash at 256 / 1024 / 1500 / 2000 rows, a decode step over
    all four, and a chunk of 256 rows after the 256- and the 1500-row
    histories. Planted faults: ``lengths - 1`` to the decode kernel and
    ``history - 1`` to the chunk kernel (``phase_model``'s). Returns the
    worst logit differences."""
    from unittest import mock

    import torch
    from gofr_tpu_torch.models import llama as llama_module
    from gofr_tpu_torch.models.llama import (llama_decode_step_paged,
                                             llama_prefill_chunk_paged,
                                             llama_prefill_last, make_pool)
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk_kv

    def short_by_one(q, k_pool, v_pool, tables, lengths):
        return paged_decode_attention(q, k_pool, v_pool, tables, lengths - 1)

    def history_short_by_one(q, k_pool, v_pool, tables, history, chunk):
        return paged_chunk_attention(q, k_pool, v_pool, tables,
                                     (history - 1).clamp(min=0), chunk)

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    p, s, pg, mp = 4, 2048, 64, 32
    lens = torch.tensor([256, 1024, 1500, 2000], dtype=torch.int32,
                        device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (p, s), generator=gen,
                           device=dev)
    tables = torch.arange(p * mp, dtype=torch.int32,
                          device=dev).reshape(p, mp)
    _, (k, v) = llama_prefill_last(params, tokens, cfg, kv_lengths=lens)
    kp, vp = make_pool(cfg, p * mp, pg, dev)
    scatter_chunk_kv(kp, vp, tables, k, v, torch.zeros_like(lens), lens)
    del k, v
    step = torch.randint(0, cfg.vocab_size, (p,), generator=gen, device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                          device=dev)
    rows = torch.tensor([0, 2], device=dev)
    offsets = lens[rows].contiguous()
    clen = torch.full((2,), 256, dtype=torch.int32, device=dev)
    out: dict = {}
    for run in ("auto", "plain", "fault"):
        impl = "plain" if run == "plain" else "auto"
        with mock.patch.object(llama_module, "paged_decode_attention",
                               short_by_one if run == "fault"
                               else paged_decode_attention), \
                mock.patch.object(llama_module, "paged_chunk_attention",
                                  history_short_by_one if run == "fault"
                                  else paged_chunk_attention):
            dec, _, _ = llama_decode_step_paged(
                params, step, kp.clone(), vp.clone(), tables, lens, cfg,
                implementation=impl)
            chk, _, _ = llama_prefill_chunk_paged(
                params, chunk, kp.clone(), vp.clone(), tables[rows], offsets,
                clen, cfg, implementation=impl)
        out[run] = (dec, chk)
    torch.cuda.synchronize()

    def diff(run, i):
        return (out[run][i] - out["plain"][i]).abs().max().item()

    finite = all(bool(torch.isfinite(t).all()) for pair in out.values()
                 for t in pair)
    return {"decode_logits_diff": diff("auto", 0),
            "chunk_logits_diff": diff("auto", 1),
            "planted_decode_logits_diff": diff("fault", 0),
            "planted_chunk_logits_diff": diff("fault", 1),
            "max_abs_logit": max(t.abs().max().item()
                                 for t in out["plain"]),
            "finite": finite}


def phase_serve_llama8b(dev, smi_line: str, cfg=None) -> dict:
    """Llama-3-8B (``LlamaConfig.llama3_8b()``: vocab 128256, dim 4096,
    32 layers, 32 q / 8 KV heads, hd 128, ffn 14336, untied head) at full
    width and depth, random bf16 weights drawn on the card from seed 0,
    served by ``build_server(llama_engine(...))`` on ``serve_config``
    (8 slots, max_seq 2048, 64-row pages, buckets 32-1024, prefix cache
    on; the autoprofiler off), each engine warmed up first and freed
    before the next. The waves: serve's three (4 prompts of 21 / 151 /
    401 / 901 tokens; one of 1801, walked; three prefix hits), 32 new
    tokens each, and serve_spec's 4 repetitive 301-token prompts, 64
    new tokens. Runs: (a) native paged, bf16 pool, all four waves; (b)
    native paged, int8 pool, speculative, all four; (c) the slot layout,
    all four; (d) the view (``paged_attention="view"``, decode windows
    512 / 1024), serve's three; (e) native, speculative
    (``spec_ngram=2``, ``spec_adaptive=False``: full depth whenever the
    prompt lookup proposes), the spec wave; (f) the slot layout,
    speculative as (e), the spec wave. Checks, each with a planted fault that must fail it:

    (a) slot and view give bit-equal tokens on wave 1, where both run
        the same prefill and the same dense decode step (plant: a view
        engine whose decode write-back lands one row late, wave 1);
    (b) the speculative runs (e) and (f) answer greedily: every token of
        every answer within LOGITS_TOL of the largest logit at its
        position when the whole answer is read back through
        ``llama_prefill`` (``_greedy_faults``), as plain decode's answers
        must be; how many answers equal the plain run's bit for bit is
        printed (plant: (f)'s engine sampling the bonus token at the
        root, not at the deepest accepted node, the spec wave again);
    (c) the walk ran on (c) and (d): the 1801-token prompt served whole
        (plant: (c)'s engine without its chunk function, wave 2);
    (d) ``spec_passes`` > 0 on (f) (plant: (c)'s, plain);
    (e) the view's prefix hits > 0 (plant: (c)'s, no prefix cache);
    (f) one decode step and one chunk call through the kernels within
        LOGITS_TOL of the plain path (``_llama8b_logits``; plants: the
        decode kernel's lengths and the chunk kernel's history one short);
    (g) graphs captured in warmup and none while serving (plant: a
        native engine never warmed up, wave 1);
    (h) the weights are 16,060,522,496 bytes within 1 % (plant: the same
        count without the LM head);
    (i) every kernel of each run's path launched (plant: (c)'s counters,
        where no paged kernel runs);
    (j) the plain runs (a), (c) and (d) answer greedily, as in (b) (the
        int8 pool's answers are printed, not gated; plant: (a)'s late
        write-back run).

    Prints TTFT per wave and decode tokens/s per run, one decode step's
    device ms on (a) and (c) and its split by kernel kind,
    ``max_memory_allocated`` and the phase's seconds. Returns the
    launches of the D = 128 kernel rows over runs (a)-(f). ``cfg``
    replaces the model (a CPU rehearsal: ``LlamaConfig.tiny().scaled(
    vocab_size=260, max_seq=2048)``)."""
    from unittest import mock

    import torch
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                             param_count)
    from gofr_tpu_torch.ops.quant import quantized_bytes
    from gofr_tpu_torch.serving import decode_graph as graph_module
    from gofr_tpu_torch.serving import engine as engine_module
    from gofr_tpu_torch.serving.app import serve_config
    from gofr_tpu_torch.serving.glue import llama_engine
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or LlamaConfig.llama3_8b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    torch.cuda.synchronize()
    weight_bytes = quantized_bytes(params)
    headless = weight_bytes - quantized_bytes({"h": params["lm_head"]})
    want_bytes = LLAMA8B_BYTES if cfg == LlamaConfig.llama3_8b() \
        else param_count(params) * params["embed"].element_size()
    init_s = time.perf_counter() - t_phase
    logit = _llama8b_logits(params, cfg, dev)

    waves, spec_wave = _serve_waves(), [_spec_prompts()]
    counters = _llama8b_counters()
    spec = {"speculative": True, "spec_ngram": 2}
    view = {"kv_layout": "paged", "paged_attention": "view",
            "decode_windows": LLAMA8B_WINDOWS}

    def serve(name, run_waves=None, n_new=None, engine=None, **overrides):
        run_waves = run_waves or waves + spec_wave
        n_new = n_new or [LLAMA8B_NEW] * len(waves) + [LLAMA8B_SPEC_NEW]
        return _serve_run(params, cfg, dev, smi_line, name, run_waves,
                          engine, build=llama_engine, phase="serve_llama8b",
                          n_new=n_new, counters=counters, **overrides)

    def again(engine, name, run_waves, n_new):
        engine.waiting.reopen()
        out = serve(name, run_waves, n_new, engine=engine)
        engine.stop()
        return out

    def free(*done):
        for run in done:
            run.pop("engine", None)
        gc.collect()
        torch.cuda.empty_cache()

    runs: dict = {}
    plants: dict = {}
    runs["native"] = serve("native")
    runs["native"].update(_llama8b_step(runs["native"]["engine"], params,
                                        cfg, dev, True))
    free(runs["native"])
    # (g)'s plant: an engine that was never warmed up captures its
    # graphs while serving
    engine = llama_engine(params, cfg, serve_config(cfg, autoprof=False),
                          device=dev)
    plants["g"] = again(engine, "planted_no_warmup", waves[:1],
                        [LLAMA8B_NEW])
    engine = None
    free(plants["g"])
    runs["native_int8"] = serve("native_int8", kv_dtype="int8", **spec)
    free(runs["native_int8"])
    runs["slot"] = serve("slot", kv_layout="slot")
    engine = runs["slot"]["engine"]
    runs["slot"].update(_llama8b_step(engine, params, cfg, dev, False))
    # (c)'s plant: no chunk function, so the long prompt is clamped
    engine._chunk_fn = None
    plants["c"] = again(engine, "planted_no_walk", waves[1:2], [LLAMA8B_NEW])
    engine = None
    free(runs["slot"], plants["c"])
    runs["view"] = serve("view", waves, [LLAMA8B_NEW] * len(waves), **view)
    free(runs["view"])
    # (a)'s plant: the view's decode write-back one row late
    real_back = graph_module.scatter_decode_kv

    def back_late(k_pool, v_pool, tables, k_view, v_view, lengths, steps):
        return real_back(k_pool, v_pool, tables, k_view, v_view,
                         lengths + 1, steps)

    with mock.patch.object(graph_module, "scatter_decode_kv", back_late):
        plants["a"] = serve("planted_late_writeback", waves[:1],
                            [LLAMA8B_NEW], **view)
    free(plants["a"])
    # (e) and (f) draft at full depth whenever the prompt lookup proposes
    runs["native_spec"] = serve("native_spec", spec_wave, [LLAMA8B_SPEC_NEW],
                                spec_adaptive=False, **spec)
    free(runs["native_spec"])
    runs["slot_spec"] = serve("slot_spec", spec_wave, [LLAMA8B_SPEC_NEW],
                              kv_layout="slot", spec_adaptive=False, **spec)
    # (b)'s plant: the bonus token sampled at the root, not at the
    # deepest accepted node
    engine = runs["slot_spec"]["engine"]
    real_resolve = engine_module.resolve_tree

    def root_bonus(logits, tokens, *args, **kw):
        n_acc, bonus, path = real_resolve(logits, tokens, *args, **kw)
        return n_acc, logits[:, 0].argmax(-1).to(bonus.dtype), path

    with mock.patch.object(engine_module, "resolve_tree", root_bonus):
        plants["b"] = again(engine, "planted_root_bonus", spec_wave,
                            [LLAMA8B_SPEC_NEW])
    engine = None
    free(runs["slot_spec"], plants["b"])

    greedy = {name: _greedy_faults(run, params, cfg, dev)
              for name, run in (*runs.items(), *plants.items())
              if name not in ("c", "g")}
    wave1 = list(range(4))
    spec_equal = {name: sum(run["tokens"][i] == runs[ref]["tokens"][a]
                            for i, a in enumerate(SPEC_ANSWERS))
                  for name, ref in (("native_spec", "native"),
                                    ("slot_spec", "slot"))
                  for run in (runs[name],)}

    def spec_faults(run):
        return [] if run["spec_passes"] > 0 else \
            [f"{run['run']}: no speculative pass"]

    def prefix_faults(run):
        return [] if run["prefix_hits"] > 0 else \
            [f"{run['run']}: no prefix hit"]

    def logit_faults(*errs):
        return [f"logits diff {e} > {LOGITS_TOL}" for e in errs
                if not logit["finite"] or e > LOGITS_TOL]

    def bytes_faults(n):
        return [] if abs(n - want_bytes) <= 0.01 * want_bytes else \
            [f"weights {n} bytes, not {want_bytes} within 1 %"]

    paths = {"native": ["flash_attention", "paged_decode_attention",
                        "paged_chunk_attention", "rope_kv_write",
                        "scatter_chunk_kv"],
             "native_int8": ["flash_attention", "paged_decode_attention_int8",
                             "paged_chunk_attention_int8",
                             "paged_tree_attention_int8",
                             "rope_kv_write_int8", "scatter_chunk_kv_int8"],
             "slot": ["flash_attention"],
             "view": ["flash_attention", "scatter_chunk_kv"],
             "native_spec": ["paged_tree_attention", "rope_kv_write"],
             "slot_spec": ["flash_attention"]}

    def launch_faults(name, run):
        return [f"{name}: {k} never launched" for k in paths[name]
                if run["launches"][k] < 1]

    served = [f for run in runs.values() for f in _served_faults(run)]
    checks = {
        "a_slot_equals_view": (_equal_faults(runs["view"], runs["slot"], wave1)
                               + served,
                               _equal_faults(plants["a"], runs["slot"],
                                             wave1)),
        "b_spec_greedy_as_plain": (greedy["native_spec"][0]
                                   + greedy["slot_spec"][0],
                                   greedy["b"][0]),
        "c_walk": (_walk_faults(runs["slot"]) + _walk_faults(runs["view"]),
                   _walk_faults(plants["c"])),
        "d_spec_passes": (spec_faults(runs["slot_spec"]),
                          spec_faults(runs["slot"])),
        "e_prefix_hits": (prefix_faults(runs["view"]),
                          prefix_faults(runs["slot"])),
        "f_logits": (logit_faults(logit["decode_logits_diff"],
                                  logit["chunk_logits_diff"]),
                     logit_faults(logit["planted_decode_logits_diff"])
                     and logit_faults(logit["planted_chunk_logits_diff"])),
        "g_captures": ([f for run in runs.values()
                        for f in _capture_faults(run)],
                       _capture_faults(plants["g"])),
        "h_weight_bytes": (bytes_faults(weight_bytes),
                           bytes_faults(headless)),
        "i_launches": ([f for name, run in runs.items()
                        for f in launch_faults(name, run)],
                       launch_faults("native", runs["slot"])),
        "j_greedy": ([f for name in ("native", "slot", "view")
                      for f in greedy[name][0]], greedy["a"][0]),
    }
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    launches = {key: sum(run["launches"][key] for run in runs.values())
                for key in counters}
    summary = {
        "phase": "serve_llama8b", "card": smi_line,
        "config": "llama3_8b, 32 layers, bf16, random seed 0",
        "weight_bytes": weight_bytes, "want_weight_bytes": want_bytes,
        "init_s": init_s, **logit, "tolerance": LOGITS_TOL,
        "greedy": {name: g[1] for name, g in greedy.items()},
        "spec_answers_equal_to_plain": spec_equal,
        "ttft_ms": {k: r["ttft_ms"] for k, r in runs.items()},
        "decode_tokens_per_s": {k: r["decode_tokens_per_s"]
                                for k, r in runs.items()},
        "spec": {k: {s_: r[s_] for s_ in ("spec_passes", "spec_drafted",
                                         "spec_accepted")}
                 for k, r in runs.items() if r["spec_passes"]},
        "prefix_hits": {k: r["prefix_hits"] for k, r in runs.items()},
        "run_wall_s": {k: r["run_wall_s"] for k, r in runs.items()},
        "decode_step": {k: {s_: runs[k][s_] for s_ in (
            "decode_step_device_ms", "decode_step_ms",
            "decode_step_by_kind")} for k in ("native", "slot")},
        "launches": launches,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "phase_wall_s": time.perf_counter() - t_phase,
        "failed_checks": failed, "planted": planted}
    emit(summary)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_llama8b: failed checks {failed}, "
                             f"planted faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- every head dim and type
#: openlm-research/open_llama_3b_v2's config.json as published on the
#: Hugging Face hub, with ``rope_theta`` written out: 10000.0 is
#: transformers' ``LlamaConfig`` default, and the published file names
#: no such key (``llama_config_from_hf`` reads an absent key as 500000,
#: as JAX's loader does)
OPENLLAMA_3B_V2 = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0,
    "hidden_act": "silu", "hidden_size": 3200, "initializer_range": 0.02,
    "intermediate_size": 8640, "max_position_embeddings": 2048,
    "num_attention_heads": 32, "num_hidden_layers": 26,
    "num_key_value_heads": 32, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "torch_dtype": "float16",
    "use_cache": True, "vocab_size": 32000, "rope_theta": 10000.0}
#: its parameters: the 32000 x 3200 embedding and head, 26 layers of 4 x
#: 3200² + 3 x 3200 x 8640 + 2 x 3200, the final norm
OPENLLAMA_PARAMS = 3_426_473_600
OPENLLAMA_NEW = 32
#: serve_shapes' new tokens an answer
SHAPES_NEW = 16


def _shape_launch_faults(name: str, run: dict, quantized: bool,
                         kernels=("flash_attention", "paged_decode_attention",
                                  "paged_chunk_attention", "rope_kv_write",
                                  "scatter_chunk_kv")) -> list:
    """The kernels of a native paged run, in its pool's form, each
    launched at least once (flash has one form)."""
    form = "_int8" if quantized else ""
    want = [k if k == "flash_attention" else k + form for k in kernels]
    return [f"{name}: {k} never launched" for k in want
            if run["launches"].get(k, 0) < 1]


def _pool_faults(name: str, pages: int, nbytes: int, ref: dict) -> list:
    """An int8 pool at the plain pool's bytes: at least 1.8x its pages
    in no more bytes."""
    if pages >= 1.8 * ref["pool_pages"] and nbytes <= ref["pool_bytes"]:
        return []
    return [f"{name}: {pages} pages in {nbytes} bytes against the plain "
            f"pool's {ref['pool_pages']} in {ref['pool_bytes']}"]


def _rotated(run: dict) -> dict:
    """A planted fault: ``run`` with each answer's tokens rotated by one
    place (every token at another position)."""
    return {**run, "run": run["run"] + "_rotated",
            "tokens": [t[1:] + t[:1] if t else t for t in run["tokens"]]}


def _serve_pools(params, cfg, dev, smi_line: str, phase: str, n_new: int,
                 counters: dict) -> dict:
    """serve's three waves through ``_serve_run`` on a ``llama_engine``,
    once on the plain pool (the model's dtype) and once on the int8 pool
    at the same bytes, each engine freed before the next; the runs by
    pool, each with its pool's pages and bytes."""
    import torch
    from gofr_tpu_torch.serving.glue import llama_engine
    runs = {}
    for name, kv_dtype in (("plain_pool", "bf16"), ("int8_pool", "int8")):
        run = _serve_run(params, cfg, dev, smi_line, name, _serve_waves(),
                         build=llama_engine, phase=phase, n_new=n_new,
                         counters=counters, kv_dtype=kv_dtype)
        engine = run.pop("engine")
        run.update(pool_pages=engine._n_pages, pool_bytes=_pool_bytes(engine))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        runs[name] = run
    return runs


def phase_serve_openllama(dev, smi_line: str, hf: dict | None = None
                          ) -> dict:
    """OpenLLaMA-3B v2 (``OPENLLAMA_3B_V2`` through
    ``llama_config_from_hf``, its ``torch_dtype`` through
    ``resolve_serving_dtype``: vocab 32000, dim 3200, 26 layers, 32 q /
    32 KV heads, head_dim 100, ffn 8640, untied, float16) at full width
    and depth, random float16 weights drawn on the card from seed 0 (no
    weights are read), served by ``build_server(llama_engine(...))`` on
    ``serve_config`` (8 slots, max_seq 2048, 64-row pages, 256 of them,
    buckets 32-1024, prefix cache on; the autoprofiler off), warmed up
    first: serve's three waves (4 prompts of 21 / 151 / 401 / 901
    tokens; one of 1801, walked through the chunk kernel; three prefix
    hits), 32 new tokens each, greedy, on the float16 pool and again on
    the int8 pool at the same bytes. Checks, each with a planted fault
    it must reject where one is named:

    (a) every answer 201 with its 32 tokens, the 1801-token prompt served
        whole, prefix hits, graphs captured in warmup and none while
        serving, on both pools;
    (b) the float16 pool's answers are the plain path's greedy answers:
        each answer's prompt and tokens through ``llama_prefill(...,
        implementation="plain")`` in one pass, every token the largest
        logit at its position or within LOGITS_TOL of it (a near tie;
        the int8 pool's answers are printed, not gated: its rounding
        moves logits by more than a random model's gaps) (plant: the
        answers with their tokens rotated one place);
    (c) one decode step and one chunk call through the kernels within
        LOGITS_TOL of the plain path (``_llama8b_logits``; plants: the
        decode kernel's lengths and the chunk kernel's history one
        short);
    (d) flash, and in each run's pool form paged decode, paged chunk,
        ``rope_kv_write`` and the slab write, launched (plant: the
        float16 run's counters read for the int8 kernels);
    (e) the int8 pool holds at least 1.8x the pages in no more bytes
        (plant: the float16 pool against itself);
    (f) 3,426,473,600 parameters, two bytes each (plant: the count
        without the LM head).

    Prints TTFT per wave and decode tokens/s per run, pool pages and
    bytes, ``max_memory_allocated`` and the phase's seconds. Returns the
    launches over both runs. ``hf`` replaces the config (a CPU
    rehearsal)."""
    import torch
    from gofr_tpu_torch.models.hf_checkpoint import (llama_config_from_hf,
                                                     resolve_serving_dtype)
    from gofr_tpu_torch.models.llama import llama_init, param_count
    from gofr_tpu_torch.ops.quant import quantized_bytes
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hf = hf or OPENLLAMA_3B_V2
    cfg = llama_config_from_hf(hf).scaled(
        dtype=resolve_serving_dtype(hf["torch_dtype"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    weight_bytes = quantized_bytes(params)
    headless = n_params - params["lm_head"].numel()
    want_params = OPENLLAMA_PARAMS if hf is OPENLLAMA_3B_V2 else n_params
    init_s = time.perf_counter() - t_phase
    logit = _llama8b_logits(params, cfg, dev)
    counters = _llama8b_counters()
    runs = _serve_pools(params, cfg, dev, smi_line, "serve_openllama",
                        OPENLLAMA_NEW, counters)
    plain, int8 = runs["plain_pool"], runs["int8_pool"]
    greedy = {name: _greedy_faults(run, params, cfg, dev,
                                   implementation="plain")
              for name, run in (*runs.items(),
                                ("rotated", _rotated(plain)))}

    def served(run):
        faults = _served_faults(run) + _walk_faults(run) \
            + _capture_faults(run)
        return faults + ([] if run["prefix_hits"] > 0 else
                         [f"{run['run']}: no prefix hit"])

    def logit_faults(*errs):
        return [f"logits diff {e} > {LOGITS_TOL}" for e in errs
                if not logit["finite"] or e > LOGITS_TOL]

    def count_faults(n, nbytes):
        return [] if n == want_params and nbytes == 2 * n else \
            [f"{n} parameters in {nbytes} bytes, not {want_params} in "
             f"{2 * want_params}"]

    checks = {
        "a_served": (served(plain) + served(int8), None),
        "b_greedy_as_plain": (greedy["plain_pool"][0], greedy["rotated"][0]),
        "c_logits": (logit_faults(logit["decode_logits_diff"],
                                  logit["chunk_logits_diff"]),
                     logit_faults(logit["planted_decode_logits_diff"])
                     and logit_faults(logit["planted_chunk_logits_diff"])),
        "d_launches": (_shape_launch_faults("plain_pool", plain, False)
                       + _shape_launch_faults("int8_pool", int8, True),
                       _shape_launch_faults("plain_pool", plain, True)),
        "e_int8_pool": (_pool_faults("int8_pool", int8["pool_pages"],
                                     int8["pool_bytes"], plain),
                        _pool_faults("plain_pool", plain["pool_pages"],
                                     plain["pool_bytes"], plain)),
        "f_parameters": (count_faults(n_params, weight_bytes),
                         count_faults(headless, 2 * headless)),
    }
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items() if v[1] is not None}
    launches = {key: sum(run["launches"][key] for run in runs.values())
                for key in counters}
    emit({"phase": "serve_openllama", "card": smi_line,
          "config": {k: hf[k] for k in (
              "vocab_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads",
              "intermediate_size", "rope_theta", "torch_dtype")},
          "head_dim": cfg.head_dim, "parameters": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s, **logit,
          "tolerance": LOGITS_TOL,
          "greedy": {name: g[1] for name, g in greedy.items()},
          "pool_pages": {k: r["pool_pages"] for k, r in runs.items()},
          "pool_bytes": {k: r["pool_bytes"] for k, r in runs.items()},
          "ttft_ms": {k: r["ttft_ms"] for k, r in runs.items()},
          "wall_s_per_wave": {k: r["wall_s_per_wave"]
                              for k, r in runs.items()},
          "decode_tokens_per_s": {k: r["decode_tokens_per_s"]
                                  for k, r in runs.items()},
          "prefix_hits": {k: r["prefix_hits"] for k, r in runs.items()},
          "run_wall_s": {k: r["run_wall_s"] for k, r in runs.items()},
          "warmup_s": {k: r["warmup_s"] for k, r in runs.items()},
          "launches": launches,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
          / 2 ** 30,
          "phase_wall_s": time.perf_counter() - t_phase,
          "failed_checks": failed, "planted": planted})
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_openllama: failed checks {failed}, "
                             f"planted faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _shape_models() -> dict:
    """serve_shapes' small models, 2 layers each, at the other kernel
    rows' head dims and types: 8 q / 2 KV heads of 256 in bf16 (dim
    2048), and Llama-3.2-1B's heads (32 q / 8 KV of 64, dim 2048) in
    float16; vocabulary 512 (the byte tokenizer's ids fit)."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig
    return {
        "serve_shapes_d256": LlamaConfig(
            vocab_size=512, dim=2048, n_layers=2, n_heads=8, n_kv_heads=2,
            ffn_dim=4096, max_seq=2048, dtype=torch.bfloat16),
        "serve_shapes_d64": LlamaConfig.llama3_1b().scaled(
            vocab_size=512, n_layers=2, dtype=torch.float16)}


def _demo_run(engine, name: str, prompts: list, n_new: int) -> dict:
    """``prompts`` (token ids) submitted to a started ``engine`` at once,
    greedy, then, once all are done, ``prompts[0]``'s first 64 ids and a
    new tail (a prefix hit: its suffix walks through the chunk kernel);
    the run's prompts, tokens and the engine's stats."""
    from gofr_tpu_torch.serving.engine import SamplingParams
    greedy = SamplingParams(temperature=0.0, max_new_tokens=n_new)
    waves = [prompts, [prompts[0][:64] + [7, 11, 13, 17, 19, 23, 29, 31]]]
    reqs = []
    for wave in waves:
        got = [engine.submit(p, greedy) for p in wave]
        for r in got:
            if not r.done.wait(600):
                raise AssertionError(f"{name}: a request did not finish")
        reqs += got
    return {"run": name, "prompts": [r.prompt_tokens for r in reqs],
            "tokens": [list(r.generated) for r in reqs],
            "errors": [r.error for r in reqs if r.error],
            "prefix_hits": engine.stats["prefix_hits"],
            "prefill_calls": engine.stats["prefill_calls"]}


def _model_dtype_run(params, cfg, dev) -> dict:
    """``params`` (float16) written as an HF checkpoint in a temporary
    directory and served as ``python -m gofr_tpu_torch.serving.app``
    serves it with ``MODEL_DTYPE=float16`` (``app_engine``: the config
    read back, its dtype from ``resolve_serving_dtype``), one greedy
    request of byte-tokenizer ids; and the same ids through an in-memory
    ``llama_engine`` on ``params`` and the same engine config. Returns
    both answers and the served engine's weight and pool dtypes."""
    import tempfile

    from gofr_tpu_torch.models.hf_checkpoint import save_llama_checkpoint
    from gofr_tpu_torch.serving.app import app_engine, serve_config
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    greedy = SamplingParams(temperature=0.0, max_new_tokens=SHAPES_NEW)
    answers, dtypes = [], []
    with tempfile.TemporaryDirectory() as tmp:
        save_llama_checkpoint(params, cfg, tmp)
        served, tokenizer, _ = app_engine(
            {"MODEL_PATH": tmp, "MODEL_DTYPE": "float16",
             "MODEL_MAX_SEQ": str(cfg.max_seq)}, device=dev)
    ids = tokenizer.encode("a float16 checkpoint served as its own dtype")
    twin = llama_engine(params, cfg, serve_config(cfg, max_seq=cfg.max_seq,
                                                  eos_id=-1), device=dev)
    for engine in (served, twin):
        engine.start()
        try:
            req = engine.submit_sync(ids, greedy, 600)
        finally:
            engine.stop()
        answers.append(list(req.generated) if not req.error else req.error)
        dtypes.append([str(engine.params["layers"]["wq"].dtype),
                       str(engine.k_cache.dtype)])
    return {"tokens": answers[0], "in_memory_tokens": answers[1],
            "dtypes": dtypes[0]}


def phase_serve_shapes(dev, smi_line: str, models: dict | None = None
                       ) -> dict:
    """The kernels at the other head dims and types, on the main path:

    (a) ``demo_llama_engine()`` on the card serves JAX's demo model
        itself (``LlamaConfig.tiny()``: float32, head_dim 16; the bf16
        twin it once served on CUDA is gone), on its default
        ``EngineConfig(max_batch=4, max_seq=128)`` and again with
        ``kv_dtype="int8"``: three prompts of 70 / 20 / 100 token ids at
        once, then a prefix hit on the first one's 64-row page, 16 new
        tokens each;
    (b) ``examples_torch/model-serving``'s ``build_app`` at its default
        preset (``tiny``, vocabulary 260) answers ``/chat`` and
        ``/v1/chat/completions``, 16 new tokens each;
    (c) two small models at the kernel rows' other shapes
        (``_shape_models``: head_dim 256 in bf16, head_dim 64 in
        float16) served as ``serve_openllama`` serves its model, on both
        pools, 16 new tokens an answer;
    (d) the float16 model as an HF checkpoint, served by ``app_engine``
        with ``MODEL_DTYPE=float16`` (``_model_dtype_run``): float16
        weights and pool, the in-memory engine's tokens bit for bit.

    Checks, each with a planted fault it must reject where one is named:
    every answer complete (in (c) also the walk, prefix hits and
    captures); each plain-pool answer the plain path's greedy answer or
    parting at a near tie (``_greedy_faults(implementation="plain")``;
    plant: (a)'s answers rotated one place); flash, paged decode and
    ``rope_kv_write`` launched in every run (paged chunk and the slab
    write too in (a) and (c)) in the run's pool form (plant: (a)'s
    float16 counters read for the int8 kernels); (a)'s model is
    ``LlamaConfig.tiny()``, float32 at head_dim 16 (plant: the bf16
    twin's shapes). Returns the launches by source: ``serve_shapes_tiny``
    ((a) and (b)), ``serve_shapes_d256``, ``serve_shapes_d64``.
    ``models`` replaces (c)'s models (a CPU rehearsal)."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import demo_config, demo_llama_engine
    t_phase = time.perf_counter()
    counters = _llama8b_counters()
    checks: dict = {}
    out: dict = {"phase": "serve_shapes", "card": smi_line}
    sources: dict = {}

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    # (a) the demo engine, both pools
    tiny = demo_config(dev)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, tiny.vocab_size, (n,), generator=gen)
               .tolist() for n in (70, 20, 100)]
    demo: dict = {}
    for name, kv_dtype in (("demo_plain_pool", "bf16"),
                           ("demo_int8_pool", "int8")):
        engine = demo_llama_engine(EngineConfig(max_batch=4, max_seq=128,
                                                kv_dtype=kv_dtype),
                                   device=dev)
        wq = engine.params["layers"]["wq"]
        zero()
        engine.start()
        try:
            run = _demo_run(engine, name, prompts, SHAPES_NEW)
        finally:
            engine.stop()
        run.update(launches=read(), dtype=str(wq.dtype),
                   head_dim=wq.shape[-1] // tiny.n_heads,
                   params=engine.params)
        demo[name] = run
        del engine
    twin = LlamaConfig.tiny().scaled(dim=512, n_heads=8, n_kv_heads=2,
                                     ffn_dim=1024, dtype=torch.bfloat16)

    def tiny_faults(c):
        return [] if (c == LlamaConfig.tiny() and all(
            (r["dtype"], r["head_dim"]) == ("torch.float32", 16)
            for r in demo.values())) else [f"demo model {c}"]

    def complete(run, n_new):
        return [f"{run['run']}: {run['errors'] or 'short answers'}"
                for _ in [0] if run["errors"] or any(
                    len(t) != n_new for t in run["tokens"])]

    plain_demo = demo["demo_plain_pool"]
    greedy = {k: _greedy_faults(r, r["params"], tiny, dev,
                                implementation="plain")
              for k, r in (*demo.items(),
                           ("rotated", _rotated(plain_demo)))}
    checks["a_demo_model"] = (tiny_faults(tiny), tiny_faults(twin))
    checks["a_demo_served"] = (
        [f for r in demo.values() for f in complete(r, SHAPES_NEW)]
        + [f"{r['run']}: no prefix hit" for r in demo.values()
           if r["prefix_hits"] < 1], None)
    checks["a_demo_greedy"] = (greedy["demo_plain_pool"][0],
                               greedy["rotated"][0])
    checks["a_demo_launches"] = (
        _shape_launch_faults("demo_plain_pool", plain_demo, False)
        + _shape_launch_faults("demo_int8_pool", demo["demo_int8_pool"],
                               True),
        _shape_launch_faults("demo_plain_pool", plain_demo, True))
    out["demo"] = {k: {"launches": r["launches"],
                       "prefix_hits": r["prefix_hits"],
                       "greedy": greedy[k][1]} for k, r in demo.items()}

    # (b) the model-serving example at its default preset
    app = _ex_app("model-serving", dev)
    engine = app.container.get_model("llama")
    made = _ex_made(engine)
    ex_cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    zero()
    loop, thread = _boot_app(app, "serve_shapes (b)")
    try:
        port = app.port
        chat = _http_json(port, "POST", "/chat", {
            "prompt": "the demo model answers on the card now",
            "max_tokens": SHAPES_NEW, "temperature": 0})
        v1 = _http_json(port, "POST", "/v1/chat/completions", {
            "model": "tiny", "max_tokens": SHAPES_NEW, "temperature": 0,
            "messages": [{"role": "user",
                          "content": "and through the OpenAI route too"}]})
        ex_launches = read()
    finally:
        _stop_app(app, loop, thread)
    ex_run = {"run": "example_tiny",
              "prompts": [r.prompt_tokens for r in made],
              "tokens": [list(r.generated) for r in made]}
    ex_greedy = _greedy_faults(ex_run, engine.params, ex_cfg, dev,
                               implementation="plain")
    statuses = [chat[0], v1[0]]
    checks["b_example"] = (
        ([] if all(c in (200, 201) for c in statuses) else
         [f"example answers {statuses}"])
        + ([] if len(made) == 2 and all(len(t) == SHAPES_NEW
                                        for t in ex_run["tokens"])
           else [f"example tokens {[len(t) for t in ex_run['tokens']]}"])
        + ex_greedy[0]
        + [f"example: {k} never launched" for k in (
            "flash_attention", "paged_decode_attention", "rope_kv_write")
           if ex_launches[k] < 1], None)
    out["example"] = {"statuses": statuses, "launches": ex_launches,
                      "greedy": ex_greedy[1],
                      "chat_text": chat[2].get("data", {}).get("text")}
    sources["serve_shapes_tiny"] = {
        k: plain_demo["launches"][k] + demo["demo_int8_pool"]["launches"][k]
        + ex_launches[k] for k in counters}
    for run in demo.values():
        run.pop("params")
    del app, engine, made
    gc.collect()

    # (c) the small models at head_dim 256 (bf16) and 64 (float16)
    for source, cfg in (models or _shape_models()).items():
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = llama_init(cfg, g, dev)
        runs = _serve_pools(params, cfg, dev, smi_line, "serve_shapes",
                            SHAPES_NEW, counters)
        plain, int8 = runs["plain_pool"], runs["int8_pool"]
        greedy = _greedy_faults(plain, params, cfg, dev,
                                implementation="plain")
        tag = source[len("serve_shapes_"):]

        def served(run):
            return _served_faults(run) + _walk_faults(run) \
                + _capture_faults(run) \
                + ([] if run["prefix_hits"] > 0 else
                   [f"{run['run']}: no prefix hit"])

        checks[f"c_{tag}_served"] = (served(plain) + served(int8), None)
        checks[f"c_{tag}_greedy"] = (greedy[0], None)
        checks[f"c_{tag}_launches"] = (
            _shape_launch_faults(f"{tag} plain_pool", plain, False)
            + _shape_launch_faults(f"{tag} int8_pool", int8, True), None)
        sources[source] = {k: plain["launches"][k] + int8["launches"][k]
                           for k in counters}
        if cfg.dtype == torch.float16:
            ckpt = _model_dtype_run(params, cfg, dev)
            checks["d_model_dtype"] = (
                [] if ckpt["tokens"] == ckpt["in_memory_tokens"]
                and ckpt["dtypes"] == ["torch.float16"] * 2
                else [f"MODEL_DTYPE=float16: {ckpt}"], None)
            out["model_dtype"] = ckpt
        out[tag] = {"head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
                    "greedy": greedy[1],
                    "ttft_ms": {k: r["ttft_ms"] for k, r in runs.items()},
                    "decode_tokens_per_s": {
                        k: r["decode_tokens_per_s"] for k, r in runs.items()},
                    "pool_pages": {k: r["pool_pages"]
                                   for k, r in runs.items()},
                    "launches": sources[source]}
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items() if v[1] is not None}
    out.update(phase_wall_s=time.perf_counter() - t_phase,
               failed_checks=failed, planted=planted)
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_shapes: failed checks {failed}, "
                             f"planted faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return sources


# ---------------------------------------------------------------- encoders
#: serve_embed: |‖e‖ - 1| of a returned embedding; 1 - cosine between a
#: text's embedding alone and its row of the padded batch, and between
#: the bf16 and the float32 path (measured ≤ 4e-6 at BERT-base width on
#: the host, 4 layers); float32 hidden states, card against host (float32
#: summation order: ≤ 3e-6 on the host against float64 products, 4
#: layers; a non-tanh gelu moves them 7.7e-4)
EMBED_NORM_TOL = 1e-5
EMBED_COS_TOL = 1e-3
EMBED_F32_TOL = 1e-4
#: serve_asr: the card's log-mel against a float64 numpy evaluation of
#: the recipe (float32 FFT: ≤ 5e-5 on the host; a symmetric Hann window
#: moves it 0.04-0.25); bf16 encoder states against the float32 path, the
#: worst frame's relative L2 error (bf16 rounding: 0.007-0.009 on the
#: host at 4-8 layers of 384; the stride-2 conv padded (1, 1) gives
#: 0.05-0.12, at the frames where the audio changes)
MEL_TOL = 1e-3
ENC_FRAME_TOL = 0.03
#: the utterances, seconds of 16 kHz PCM
ASR_SECONDS = (1, 5, 10, 30)
EMBED_BUCKETS = (16, 32, 64, 128, 256, 512)


def _bound_faults(name: str, value: float, limit: float) -> list:
    return [] if value <= limit else [f"{name} {value:.3g} > {limit:g}"]


def _embed_texts(seed: int, n: int, lo: int, hi: int) -> list:
    """``n`` texts of ``lo``-``hi`` bytes: lowercase words drawn from a
    seeded generator."""
    import numpy as np
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    texts = []
    for length in rng.integers(lo, hi + 1, n):
        words = []
        while sum(len(w) + 1 for w in words) < length:
            words.append("".join(rng.choice(letters, rng.integers(2, 10))))
        texts.append(" ".join(words)[:length])
    return texts


def _embed_ids(tok, texts: list):
    """The padded ids and mask ``make_embed_handler`` builds for
    ``texts`` (ids cut to 512, the least bucket holding the longest)."""
    import numpy as np
    lists = [tok.encode(t)[:512] for t in texts]
    bucket = next((b for b in EMBED_BUCKETS
                   if max(map(len, lists)) <= b), EMBED_BUCKETS[-1])
    ids = np.zeros((len(texts), bucket), np.int64)
    mask = np.zeros((len(texts), bucket), np.int32)
    for i, ts in enumerate(lists):
        ids[i, :len(ts)] = ts
        mask[i, :len(ts)] = 1
    return ids, mask


def _cos_gap(a, b) -> list:
    """1 - cosine of each row pair of two [N, D] arrays."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (1.0 - (a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).tolist()


def _tree_float(tree: dict, device=None) -> dict:
    return {k: _tree_float(v, device) if isinstance(v, dict)
            else v.float().to(device or v.device) for k, v in tree.items()}


def _flat(tree: dict, prefix: str = "") -> dict:
    """A nested tree's leaves by path (``dec_layers/wq``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tree_bytes(tree: dict) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def _top_kernels(fn, n: int = 6) -> dict:
    """One ``torch.profiler`` trace of ``fn`` (after one untraced call):
    the device ms and kernel count in all, and the ``n`` kernels that
    took the most device time, each with its ms and count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = names.get(e.name, (0.0, 0))
            names[e.name] = (ms + (e.time_range.end - e.time_range.start)
                             / 1e3, k + 1)
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ms": sum(ms for ms, _ in names.values()),
            "kernels": sum(k for _, k in names.values()),
            "top": [{"name": name[:80], "ms": ms, "n": k}
                    for name, (ms, k) in top]}


def _serving(server):
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    return thread


def _stop(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(30)


def phase_serve_embed(dev, smi_line: str, cfg=None) -> None:
    """BERT-base (``BertConfig.base()``: 12 layers, dim 768, 12 heads, ffn
    3072, vocab 30522, bf16), random weights from seed 0, behind ``POST
    /embed`` of ``embed_app`` (an engine-less server, the byte
    tokenizer). Checks, each with a planted fault that must fail it:

    (a) 32 texts of 20-500 bytes in one request: 32 finite embeddings of
        dim 768 of norm 1 within ``EMBED_NORM_TOL``; planted: the masked
        mean of the same hidden states without its L2 normalisation;
    (b) each text alone equals its row of the padded batch within
        ``EMBED_COS_TOL`` (1 - cosine); planted: the batch encoded without
        its attention mask, so the pads are attended;
    (c) the bf16 path against a float32 copy of the weights on the card,
        within ``EMBED_COS_TOL``, and that float32 copy's hidden states
        against the same float32 weights on the host within
        ``EMBED_F32_TOL`` (four texts); planted: the exact-erf gelu in
        the card's float32 run. The erf gelu in the bf16 run is printed
        too: bf16 rounding hides it there.

    Also p50 latency of one text, sentences/s at batch 8 and 32 (100-byte
    texts, bucket 128), the encode's device ms and bound at 32 x 128, the
    weight bytes and the peak memory."""
    import dataclasses
    import numpy as np
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.models import bert
    from gofr_tpu_torch.serving.app import embed_app
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or bert.BertConfig.base()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = bert.bert_init(cfg, gen, dev)
    tok = ByteTokenizer()
    server = embed_app(params, cfg, tok, device=dev)
    thread = _serving(server)
    url = f"http://127.0.0.1:{server.port}/embed"
    checks: dict = {}
    out: dict = {"phase": "serve_embed", "card": smi_line,
                 "config": f"BERT-base: {cfg.n_layers} layers, dim {cfg.dim},"
                           f" {cfg.n_heads} heads, ffn {cfg.ffn_dim}, vocab "
                           f"{cfg.vocab_size}, {str(cfg.dtype)[6:]}, seed 0",
                 "params": bert.param_count(params),
                 "weight_bytes": _tree_bytes(params)}

    def encode(p, c, ids, mask, use_mask=True):
        with torch.inference_mode():
            m = torch.from_numpy(mask).to(dev)
            hidden, _ = bert.bert_encode(p, torch.from_numpy(ids).to(dev), c,
                                         attention_mask=m if use_mask
                                         else None)
            return hidden, bert.mean_pool_embed(hidden, m).cpu().numpy()

    try:
        texts = _embed_texts(18, 32, 20, 500)
        ids, mask = _embed_ids(tok, texts)
        # (a) the batch
        status, body = _post(url, {"input": texts})
        emb = np.asarray(body["embeddings"])
        norms = np.linalg.norm(emb, axis=-1)
        hidden, _ = encode(params, cfg, ids, mask)
        m = torch.from_numpy(mask).to(dev)[..., None].float()
        raw = ((hidden.float() * m).sum(1) / m.sum(1)).cpu().numpy()
        a_faults = ([] if status == 201 and emb.shape == (32, cfg.dim)
                    and body["dim"] == cfg.dim
                    else [f"status {status}, shape {emb.shape}"])
        a_faults += [] if np.isfinite(emb).all() else ["non-finite"]
        a_faults += _bound_faults("|norm - 1|", float(np.abs(norms - 1).max()),
                                  EMBED_NORM_TOL)
        checks["a_batch"] = (a_faults, _bound_faults(
            "|norm - 1|", float(np.abs(np.linalg.norm(raw, axis=-1)
                                       - 1).max()), EMBED_NORM_TOL))
        out["a"] = {"bucket": int(ids.shape[1]),
                    "norm_err": float(np.abs(norms - 1).max())}
        # (b) each text alone
        alone = np.asarray([_post(url, {"input": t})[1]["embeddings"][0]
                            for t in texts])
        gap = max(_cos_gap(alone, emb))
        _, unmasked = encode(params, cfg, ids, mask, use_mask=False)
        gap_bad = max(_cos_gap(alone, unmasked))
        checks["b_alone"] = (_bound_faults("1 - cos", gap, EMBED_COS_TOL),
                             _bound_faults("1 - cos", gap_bad,
                                           EMBED_COS_TOL))
        out["b"] = {"max_1_minus_cos": gap,
                    "planted_no_mask_max_1_minus_cos": gap_bad}
        # (c) bf16 against float32, and float32 card against host
        p32 = _tree_float(params)
        _, e16 = encode(params, cfg, ids, mask)
        _, e32 = encode(p32, cfg32, ids, mask)
        real_gelu = bert._gelu
        bert._gelu = F.gelu                      # the planted fault
        try:
            _, e16_erf = encode(params, cfg, ids, mask)
            short = sorted(texts, key=len)[:4]
            s_ids, s_mask = _embed_ids(tok, short)
            h32_erf, _ = encode(p32, cfg32, s_ids, s_mask)
        finally:
            bert._gelu = real_gelu
        h32, _ = encode(p32, cfg32, s_ids, s_mask)
        host, _ = bert.bert_encode(_tree_float(params, "cpu"),
                                   torch.from_numpy(s_ids), cfg32,
                                   attention_mask=torch.from_numpy(s_mask))
        valid = torch.from_numpy(s_mask).bool()
        f32_err = float((h32.cpu() - host)[valid].abs().max())
        f32_err_bad = float((h32_erf.cpu() - host)[valid].abs().max())
        c_gap = max(_cos_gap(e16, e32))
        checks["c_bf16_f32"] = (
            _bound_faults("bf16 1 - cos", c_gap, EMBED_COS_TOL)
            + _bound_faults("f32 card - host", f32_err, EMBED_F32_TOL),
            _bound_faults("f32 card - host", f32_err_bad, EMBED_F32_TOL))
        out["c"] = {"bf16_vs_f32_max_1_minus_cos": c_gap,
                    "bf16_erf_gelu_max_1_minus_cos":
                        max(_cos_gap(e16_erf, e32)),
                    "f32_card_vs_host_hidden_max_abs": f32_err,
                    "planted_erf_gelu_f32_hidden_max_abs": f32_err_bad,
                    "host_bucket": int(s_ids.shape[1])}
        del p32, e16, e32, h32, h32_erf, host
        # timings: one text, then batches of 8 and 32 at bucket 128
        one = _embed_texts(19, 1, 100, 100)
        lat = []
        for i in range(23):
            t0 = time.perf_counter()
            _post(url, {"input": one})
            if i >= 3:
                lat.append(time.perf_counter() - t0)
        out["p50_latency_ms_batch1"] = statistics.median(lat) * 1e3
        rates = {}
        for b in (8, 32):
            batch = _embed_texts(20 + b, b, 100, 100)
            walls = []
            for i in range(12):
                t0 = time.perf_counter()
                _post(url, {"input": batch})
                if i >= 2:
                    walls.append(time.perf_counter() - t0)
            rates[str(b)] = b / statistics.median(walls)
        out["sentences_per_s"] = rates
        ids32, mask32 = _embed_ids(tok, _embed_texts(52, 32, 100, 100))
        out["encode_device_ms_32x128"] = device_ms(
            lambda: encode(params, cfg, ids32, mask32), warmup=2, iters=10)
        out["encode_top_kernels_32x128"] = _top_kernels(
            lambda: encode(params, cfg, ids32, mask32))
        tokens = ids32.size
        flops = tokens * cfg.n_layers * (
            2 * (4 * cfg.dim ** 2 + 2 * cfg.dim * cfg.ffn_dim)
            + 4 * ids32.shape[1] * cfg.dim)
        out["encode_bound_ms_32x128"], out["encode_bound_by"] = bound(
            flops, _tree_bytes(params["layers"]))
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        _stop(server, thread)
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"tolerances": {"norm": EMBED_NORM_TOL, "cos": EMBED_COS_TOL,
                               "f32_hidden": EMBED_F32_TOL},
                "phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_embed: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")


def _pcm(seed: int, seconds: float):
    """Synthetic 16 kHz PCM: three tones of seeded pitch, level and phase,
    and white noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = sum(rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * rng.uniform(80, 4000)
                                             * t + rng.uniform(0, 6.3))
            for _ in range(3))
    return (x + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def _padded(audios: list, samples: int):
    import numpy as np
    out = np.zeros((len(audios), samples), np.float32)
    for i, a in enumerate(audios):
        out[i, :min(len(a), samples)] = a[:samples]
    return out


def _mel_f64(batch, n_mels: int, frames: int):
    """The log-mel recipe in float64 numpy: reflect pad, periodic Hann,
    |rfft|², the filterbank, the 8-decade clamp, (x + 4) / 4, zeros past
    the audio's frames."""
    import numpy as np
    from gofr_tpu_torch.ops.audio import mel_filterbank
    a = np.pad(batch.astype(np.float64), ((0, 0), (200, 200)),
               mode="reflect")
    n = 1 + (a.shape[1] - 400) // 160
    idx = np.arange(n)[:, None] * 160 + np.arange(400)[None, :]
    power = np.abs(np.fft.rfft(a[:, idx] * np.hanning(401)[:-1], axis=-1)) ** 2
    mel = np.log10(np.maximum(power @ mel_filterbank(n_mels)
                              .astype(np.float64), 1e-10))
    mel = (np.maximum(mel, mel.max(axis=(-2, -1), keepdims=True) - 8.0)
           + 4.0) / 4.0
    out = np.zeros((a.shape[0], frames, n_mels))
    out[:, :min(n, frames)] = mel[:, :frames]
    return out


def _readback_faults(params, cfg, mel, tokens, lengths) -> tuple:
    """Each emitted token (up to and with a row's first end-of-text)
    against the teacher-forced prefill of the same encoder states: within
    ``LOGITS_TOL`` of its position's largest logit. Returns (faults, the
    worst gap)."""
    import torch
    from gofr_tpu_torch.models import whisper as W
    with torch.inference_mode():
        enc = W.whisper_encode(params, mel, cfg)
        ck, cv = W.precompute_cross_kv(params, enc, cfg)
        b, t = tokens.shape
        inputs = torch.cat([torch.full((b, 1), cfg.sot_token,
                                       dtype=torch.int64, device=mel.device),
                            tokens[:, :-1].long()], dim=1)
        hidden, _ = W._decoder_prefill(params, inputs,
                                       torch.arange(t, device=mel.device),
                                       ck, cv, cfg)
        logits = W._logits(params, hidden, cfg)
        gap = logits.amax(-1) - logits.gather(-1, tokens.long()[..., None])[
            ..., 0]
    faults, worst = [], 0.0
    for i, n in enumerate(lengths):
        n = min(int(n) + 1, t)
        row = gap[i, :n]
        worst = max(worst, float(row.max()))
        if float(row.max()) > LOGITS_TOL:
            faults.append(f"row {i}: token {int(row.argmax())} is "
                          f"{float(row.max()):.3g} under the top logit")
    return faults, worst


def _worker_faults(batches: int, executions: int, ids: list, want: list,
                   redelivered: int) -> list:
    faults = []
    if (batches, executions) != (3, 3):
        faults.append(f"{batches} drains, {executions} device batches, "
                      f"not 3")
    if sorted(ids) != sorted(want):
        faults.append(f"request ids {sorted(ids)}")
    if redelivered:
        faults.append(f"{redelivered} uncommitted")
    return faults


def _asr_messages(n_good: int = 9, poison_at: int = 4) -> list:
    """``n_good`` 1 s utterances with their ``request_id``s and, at
    ``poison_at``, one message without audio."""
    msgs = [{"request_id": f"utt-{i}", "audio": _pcm(100 + i, 1.0).tolist()}
            for i in range(n_good)]
    msgs.insert(poison_at, {"request_id": "poison", "garbage": True})
    return msgs


def phase_serve_asr(dev, smi_line: str, preset: str = "whisper_large_v3",
                    ckpt_preset: str = "whisper_tiny") -> None:
    """Whisper-large-v3 (``preset``: dim 1280, 20 heads, 32 + 32 layers,
    128 mels, vocab 51866, bf16), random weights from seed 0, through
    ``asr_app`` (``POST /transcribe`` and the pub/sub worker), on
    synthetic PCM (tones and noise from a seed) of 1, 5, 10 and 30 s.
    Checks, each with a planted fault that must fail it:

    (a) ``log_mel_spectrogram`` on the card against ``_mel_f64`` within
        ``MEL_TOL``; planted: a symmetric Hann window;
    (b) ``whisper_encode`` in bf16 against the float32 path on the same
        weights, the worst frame's relative error within
        ``ENC_FRAME_TOL``; planted: the stride-2 conv padded (1, 1);
    (c) a batch of 8 transcribed (``max_tokens`` 64), each emitted token
        read back through the teacher-forced ``_decoder_prefill`` within
        ``LOGITS_TOL`` of its position's top logit; planted: one token
        replaced;
    (d) one ``POST /transcribe`` equals ``Transcriber.transcribe_batch``
        on the same audio; planted: the PCM sent as float64;
    (e) the app's ``ASRWorker`` (``max_batch`` 4): 10 messages, one of
        them poison, give 3 device batches, 9 results with the right
        ``request_id``s, nothing uncommitted; planted: a worker draining
        8 a batch;
    (f) ``ckpt_preset`` weights saved with ``save_whisper_checkpoint``,
        served by ``asr_app(MODEL_PATH=...)``: the loaded weights and the
        transcript bit for bit the in-memory transcriber's; planted: a
        checkpoint with decoder layers 0 and 1 swapped.

    Also the encode's device ms at batch 1, 4 and 8 and its bound, a
    decode step's ms and device ms at batch 8, utterances/s and audio
    seconds per wall second at batch 8, weight bytes, peak memory."""
    import asyncio
    import base64
    import shutil
    import tempfile
    import numpy as np
    import torch
    from gofr_tpu_torch.models import whisper as W
    from gofr_tpu_torch.ops import audio
    from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker
    from gofr_tpu_torch.serving.app import asr_app
    from gofr_tpu_torch.serving.asr import ASRConfig, ASRWorker, Transcriber
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    checks: dict = {}
    t0 = time.perf_counter()
    server = asr_app({"MODEL_PRESET": preset}, device=dev)
    thread = _serving(server)
    worker = server.asr_worker
    app_tr = worker.transcriber
    params, cfg = app_tr.params, app_tr.config
    torch.cuda.synchronize()
    out: dict = {"phase": "serve_asr", "card": smi_line,
                 "config": f"{preset}: dim {cfg.dim}, {cfg.n_heads} heads, "
                           f"{cfg.n_audio_layers} + {cfg.n_text_layers} "
                           f"layers, {cfg.n_mels} mels, vocab "
                           f"{cfg.vocab_size}, {str(cfg.dtype)[6:]}, seed 0",
                 "init_s": time.perf_counter() - t0,
                 "params": W.param_count(params),
                 "weight_bytes": _tree_bytes(params)}
    url = f"http://127.0.0.1:{server.port}/transcribe"
    utts = [_pcm(i, s) for i, s in enumerate(ASR_SECONDS)]
    utts8 = utts + [_pcm(10 + i, s) for i, s in enumerate(ASR_SECONDS)]
    try:
        # (a) the mel frontend, 4 utterances in one 30 s batch
        batch = _padded(utts, 16000 * 30)
        mel = audio.log_mel_spectrogram(
            torch.from_numpy(batch).to(dev), n_mels=cfg.n_mels,
            pad_to_frames=cfg.audio_frames)
        ref = _mel_f64(batch, cfg.n_mels, cfg.audio_frames)
        mel_err = float(np.abs(mel.double().cpu().numpy() - ref).max())
        real_window = audio._window
        audio._window = lambda n, d: torch.hann_window(
            n, periodic=False, dtype=torch.float64, device=d).float()
        try:
            bad = audio.log_mel_spectrogram(
                torch.from_numpy(batch).to(dev), n_mels=cfg.n_mels,
                pad_to_frames=cfg.audio_frames)
        finally:
            audio._window = real_window
        mel_bad = float(np.abs(bad.double().cpu().numpy() - ref).max())
        checks["a_mel"] = (_bound_faults("mel", mel_err, MEL_TOL),
                           _bound_faults("mel", mel_bad, MEL_TOL))
        out["a"] = {"max_abs_err": mel_err,
                    "planted_symmetric_hann_max_abs_err": mel_bad}
        # (b) bf16 encoder against float32
        keys = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "enc_pos",
                "enc_layers", "enc_ln_w", "enc_ln_b")
        p32 = _tree_float({k: params[k] for k in keys})
        with torch.inference_mode():
            enc32 = W.whisper_encode(p32, mel, cfg.scaled(
                dtype=torch.float32))
            del p32
            enc16 = W.whisper_encode(params, mel, cfg).float()
            real_pad = W._same_pad
            W._same_pad = lambda length, kernel, stride: (1, 1)
            try:
                enc_bad = W.whisper_encode(params, mel, cfg).float()
            finally:
                W._same_pad = real_pad

            def worst(a):
                return ((a - enc32).norm(dim=-1) / enc32.norm(dim=-1)) \
                    .amax(-1).tolist()
            frame_err, frame_bad = worst(enc16), worst(enc_bad)
        del enc32, enc16, enc_bad
        checks["b_encode"] = (
            _bound_faults("frame rel", max(frame_err), ENC_FRAME_TOL),
            _bound_faults("frame rel", max(frame_bad), ENC_FRAME_TOL))
        out["b"] = {"worst_frame_rel_err": frame_err,
                    "planted_pad_1_1_worst_frame_rel_err": frame_bad}
        # (c) a batch of 8, 64 tokens, read back
        tr8 = Transcriber(params, cfg, ASRConfig(max_batch=8,
                                                 max_tokens=64), device=dev)
        first = tr8.transcribe_batch(utts8)           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = tr8.transcribe_batch(utts8)
        wall = time.perf_counter() - t0
        out["batch8"] = {
            "wall_s": wall, "utterances_per_s": len(utts8) / wall,
            "audio_s_per_wall_s": sum(len(a) for a in utts8) / 16000 / wall,
            "samples_bucket": results[0]["samples"],
            "n_tokens": [r["n_tokens"] for r in results],
            "first_tokens": [r["tokens"][:8] for r in results],
            "deterministic": [r["tokens"] for r in results]
            == [r["tokens"] for r in first]}
        eot = cfg.eot_token
        tokens = torch.tensor([r["tokens"] + [eot] * (64 - r["n_tokens"])
                               for r in results], device=dev)
        lengths = [r["n_tokens"] for r in results]
        mel8 = audio.log_mel_spectrogram(
            torch.from_numpy(_padded(utts8, results[0]["samples"])).to(dev),
            n_mels=cfg.n_mels, pad_to_frames=cfg.audio_frames)
        c_faults, c_gap = _readback_faults(params, cfg, mel8, tokens,
                                           lengths)
        swapped = tokens.clone()
        j = min(3, lengths[0])
        swapped[0, j] = (swapped[0, j] + cfg.vocab_size // 2) \
            % cfg.vocab_size
        c_bad, c_gap_bad = _readback_faults(params, cfg, mel8, swapped,
                                            lengths)
        checks["c_readback"] = (c_faults, c_bad)
        out["c"] = {"worst_gap": c_gap, "planted_worst_gap": c_gap_bad,
                    "tolerance": LOGITS_TOL}
        # timings: encode at 1, 4, 8; one decode step at 8
        flops_utt = cfg.audio_ctx * cfg.n_audio_layers * (
            24 * cfg.dim ** 2 + 4 * cfg.audio_ctx * cfg.dim) \
            + cfg.audio_frames * 6 * cfg.n_mels * cfg.dim \
            + cfg.audio_ctx * 6 * cfg.dim ** 2
        enc_bytes = _tree_bytes(params["enc_layers"])
        enc_ms = {}
        for b in (1, 4, 8):
            with torch.inference_mode():
                ms = device_ms(lambda: W.whisper_encode(params, mel8[:b],
                                                        cfg),
                               warmup=1, iters=3)
            enc_ms[str(b)] = {"device_ms": ms,
                              "bound_ms": bound(b * flops_utt,
                                                enc_bytes)[0]}
        with torch.inference_mode():
            enc_ms["top_kernels_b8"] = _top_kernels(
                lambda: W.whisper_encode(params, mel8, cfg))
        out["encode"] = enc_ms
        with torch.inference_mode():
            enc = W.whisper_encode(params, mel8, cfg)
            ck, cv = W.precompute_cross_kv(params, enc, cfg)
            shape = (cfg.n_text_layers, 8, 65, cfg.n_heads, cfg.head_dim)
            cache_k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            cache_v = torch.zeros_like(cache_k)
            layers = W.unstack(params["dec_layers"], cfg.n_text_layers)
            step_tok = tokens[:, 32].long()
            step_len = torch.full((8,), 32, dtype=torch.int64, device=dev)

            def step():
                return W._decoder_step_kv(params, step_tok, 33, ck, cv, cfg,
                                          cache_k, cache_v, step_len, layers)
            step_ms = time_ms(step, warmup=2, iters=10)
            step_dev = device_ms(step, warmup=1, iters=5)
            step_top = _top_kernels(step)
        dec_bytes = sum(params["dec_layers"][k].numel() * 2 for k in (
            "wq", "wk", "wv", "wo", "xwq", "xwo", "fc1", "fc2")) \
            + ck.numel() * 2 * 2 + params["embed"].numel() * 2
        out["decode_step_b8"] = {
            "ms": step_ms, "device_ms": step_dev,
            "idle_share": max(0.0, 1 - step_dev / step_ms),
            "bound_ms": bound(0.0, dec_bytes)[0], "top_kernels": step_top}
        del enc, ck, cv, cache_k, cache_v
        # (d) one POST /transcribe
        one = utts[0]
        status, body = _post(url, {"audio_b64": base64.b64encode(
            one.tobytes()).decode()})
        want = app_tr.transcribe_batch([one])[0]
        _, body_bad = _post(url, {"audio_b64": base64.b64encode(
            one.astype(np.float64).tobytes()).decode()})

        def same(result):
            keys = ("tokens", "n_tokens", "batch", "samples")
            return [] if all(result.get(k) == want[k] for k in keys) \
                else [f"answer {[result.get(k) for k in keys[1:]]} "
                      f"against {[want[k] for k in keys[1:]]}"]
        checks["d_http"] = (
            ([] if status == 201 else [f"status {status}"])
            + same(body["data"]), same(body_bad["data"]))
        out["d"] = {"status": status, "tokens": body["data"]["tokens"],
                    "execute_ms": body["data"]["execute_ms"]}
        # (e) the app's worker: 10 messages, one poison
        msgs = _asr_messages()
        want_ids = [m["request_id"] for m in msgs if "audio" in m]
        broker = worker.pubsub
        before = (worker.batches, app_tr.executions)

        async def publish_all(b):
            for m in msgs:
                await b.publish("asr.requests", m)

        async def collect(b, n):
            return [(await b.subscribe("asr.results", "smoke")).bind()
                    for _ in range(n)]

        async def redeliver(b):
            return b.redeliver_uncommitted("asr.requests", "asr-workers")
        t0 = time.perf_counter()
        server.asr_loop.call(publish_all(broker), timeout=60)
        got = server.asr_loop.call(collect(broker, 9), timeout=600)
        e_wall = time.perf_counter() - t0
        e_faults = _worker_faults(
            worker.batches - before[0], app_tr.executions - before[1],
            [r["request_id"] for r in got], want_ids,
            server.asr_loop.call(redeliver(broker), timeout=60))

        async def eight_a_batch():
            b = InMemoryBroker()
            tr = Transcriber(params, cfg, ASRConfig(
                max_batch=8, max_tokens=16, sample_buckets=(16000, 80000)),
                device=dev)
            w = ASRWorker(tr, b)
            await publish_all(b)
            while w.processed < 9:
                await w.run_once()
            res = await collect(b, 9)
            return _worker_faults(w.batches, tr.executions,
                                  [r["request_id"] for r in res], want_ids,
                                  await redeliver(b))
        checks["e_worker"] = (e_faults, asyncio.run(eight_a_batch()))
        out["e"] = {"wall_s": e_wall, "batches": worker.batches - before[0],
                    "results": len(got)}
        # (f) a checkpoint at ckpt_preset's width through MODEL_PATH
        tmp = Path(tempfile.mkdtemp(prefix="gofr_whisper_"))
        try:
            out["f"], checks["f_checkpoint"] = _asr_checkpoint(
                dev, ckpt_preset, tmp, utts[1])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        _stop(server, thread)
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"tolerances": {"mel": MEL_TOL, "encode_frame": ENC_FRAME_TOL,
                               "readback": LOGITS_TOL},
                "phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_asr: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")


def _asr_checkpoint(dev, preset: str, tmp: Path, pcm) -> tuple:
    """(f): the seed-0 ``preset`` weights written as an HF checkpoint and
    served from it; a second checkpoint with decoder layers 0 and 1
    swapped is the planted fault. Returns (numbers, (faults, planted))."""
    import base64
    import torch
    from gofr_tpu_torch.models import whisper as W
    from gofr_tpu_torch.models.hf_checkpoint import save_whisper_checkpoint
    from gofr_tpu_torch.serving.app import asr_app
    from gofr_tpu_torch.serving.asr import ASRConfig, Transcriber
    cfg = getattr(W.WhisperConfig, preset)()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = W.whisper_init(cfg, gen, dev)
    want = Transcriber(params, cfg, ASRConfig(
        max_batch=4, max_tokens=16, sample_buckets=(16000, 80000)),
        device=dev).transcribe_batch([pcm])[0]
    swapped = dict(params)
    swapped["dec_layers"] = {k: v[[1, 0] + list(range(2, v.shape[0]))]
                             for k, v in params["dec_layers"].items()}
    numbers: dict = {"preset": preset, "params": W.param_count(params)}
    faults = {}
    for name, tree in (("good", params), ("swapped", swapped)):
        t0 = time.perf_counter()
        save_whisper_checkpoint(tree, cfg, tmp / name)
        numbers[f"{name}_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        app = asr_app({"MODEL_PATH": str(tmp / name)}, device=dev)
        numbers[f"{name}_load_s"] = time.perf_counter() - t0
        thread = _serving(app)
        try:
            loaded = _flat(app.asr_worker.transcriber.params)
            unequal = [k for k, v in _flat(params).items()
                       if not torch.equal(loaded[k], v)]
            status, body = _post(
                f"http://127.0.0.1:{app.port}/transcribe",
                {"audio_b64": base64.b64encode(pcm.tobytes()).decode()})
        finally:
            _stop(app, thread)
        f = [f"leaves differ: {unequal[:4]}"] if unequal else []
        if status != 201 or body["data"]["tokens"] != want["tokens"]:
            f.append(f"transcript {body['data']['tokens'][:8]} against "
                     f"{want['tokens'][:8]}")
        faults[name] = f
        numbers[f"{name}_tokens_equal"] = body["data"]["tokens"] == \
            want["tokens"]
    return numbers, (faults["good"], faults["swapped"])


#: serve_warm: the synthetic corpus the BPE merges are learned from and
#: the text the native loop is held against
WARM_MERGES = 2048
WARM_TEXT_BYTES = 1 << 20


def _warm_words(rng, n: int) -> list:
    """``n`` distinct lowercase words of 1-4 syllables from ``rng``."""
    onsets = ["", "b", "c", "d", "f", "g", "h", "k", "l", "m", "n", "p",
              "r", "s", "t", "v", "w", "st", "tr", "ch", "sh", "th", "pl"]
    nuclei = ["a", "e", "i", "o", "u", "ea", "ou", "ai", "io"]
    codas = ["", "", "n", "r", "s", "t", "l", "m", "nd", "ng", "st"]
    words: dict = {}
    while len(words) < n:
        word = "".join(onsets[rng.integers(len(onsets))]
                       + nuclei[rng.integers(len(nuclei))]
                       + codas[rng.integers(len(codas))]
                       for _ in range(int(rng.integers(1, 5))))
        words.setdefault(word, None)
    return list(words)


def _warm_text(rng, words: list, n_bytes: int) -> str:
    """About ``n_bytes`` of text: Zipf-weighted words, commas, numbers,
    capitals and line breaks, so the pre-tokenizer's every branch runs."""
    import numpy as np
    weights = 1.0 / np.arange(1, len(words) + 1)
    picks = rng.choice(len(words), size=n_bytes // 5,
                       p=weights / weights.sum())
    out, size = [], 0
    for i, w in enumerate(picks):
        word = words[w]
        r = rng.random()
        if r < 0.03:
            word = word.capitalize()
        elif r < 0.05:
            word = str(int(rng.integers(0, 100000)))
        elif r < 0.08:
            word += ","
        elif r < 0.09:
            word += ".\n"
        out.append(word)
        size += len(word) + 1
        if size >= n_bytes:
            break
    return " ".join(out)


def _learn_merges(text: str, n_merges: int) -> list:
    """Byte-level BPE merges (GPT-2 alphabet, ``"Ġ t"`` form) learned
    from the frequencies of ``text``'s space-led words: each round merges
    the most frequent adjacent pair (ties: the least pair). Pair counts
    are kept up to date word by word, so a round touches only the words
    that hold its pair."""
    import heapq
    from collections import Counter, defaultdict
    from gofr_tpu_torch.serving.tokenizer import _byte_level_table
    chars = {b: ch for ch, b in _byte_level_table().items()}
    freq = Counter(" " + w for w in text.split())
    words = [[chars[b] for b in w.encode()] for w in freq]
    counts = list(freq.values())
    pairs: Counter = Counter()
    where = defaultdict(set)

    def account(i: int, sign: int) -> set:
        syms = words[i]
        touched = set(zip(syms, syms[1:]))
        for pair in zip(syms, syms[1:]):
            pairs[pair] += sign * counts[i]
        for pair in touched:
            (where[pair].add if sign > 0 else where[pair].discard)(i)
        return touched

    for i in range(len(words)):
        account(i, 1)
    heap = [(-n, pair) for pair, n in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while len(merges) < n_merges and heap:
        neg, best = heapq.heappop(heap)
        if pairs[best] != -neg or -neg <= 0:
            continue                      # stale entry
        merges.append(f"{best[0]} {best[1]}")
        joined = best[0] + best[1]
        touched = set()
        for i in list(where[best]):
            touched |= account(i, -1)
            syms, j = words[i], 0
            while j < len(syms) - 1:
                if syms[j] == best[0] and syms[j + 1] == best[1]:
                    syms[j:j + 2] = [joined]
                j += 1
            touched |= account(i, 1)
        for pair in touched:
            if pairs[pair] > 0:
                heapq.heappush(heap, (-pairs[pair], pair))
    return merges


def _write_learned_tokenizer(path, merges: list) -> None:
    """A byte-level ``tokenizer.json``: the 256 bytes, ``merges`` (their
    tokens ids 256 on) and the Llama-3 specials."""
    from gofr_tpu_torch.serving.tokenizer import _byte_level_table
    chars = {b: ch for ch, b in _byte_level_table().items()}
    vocab = {chars[b]: b for b in range(256)}
    for pair in merges:
        vocab.setdefault(pair.replace(" ", ""), len(vocab))
    added = [{"id": 128000, "content": "<|begin_of_text|>"},
             {"id": 128001, "content": "<|end_of_text|>"}]
    Path(path).write_text(json.dumps({
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "added_tokens": added}))


def _leaf_faults(got: dict, want: dict) -> list:
    """Leaves of two flat trees that are not bit-equal (or differ in
    dtype or key)."""
    import torch
    if sorted(got) != sorted(want):
        return [f"keys {sorted(set(got) ^ set(want))[:4]}"]
    return [k for k, v in want.items()
            if got[k].dtype != v.dtype or not torch.equal(got[k], v)]


def _warm_chat(port: int, prompt: str, n_new: int) -> dict:
    """One streamed and one unary greedy ``POST /chat``: the streamed
    tokens, the seconds to the first event, the unary tokens."""
    sse = _sse_call(port, "/chat", {"prompt": prompt, "max_tokens": n_new,
                                    "temperature": 0, "stream": True})
    frames = [e for _, e in sse["events"] if isinstance(e, dict)
              and "token" in e]
    status, body = _post(f"http://127.0.0.1:{port}/chat",
                         {"prompt": prompt, "max_tokens": n_new,
                          "temperature": 0})
    return {"status": sse["status"], "unary_status": status,
            "first_event_s": sse["events"][0][0] if sse["events"] else None,
            "terminal": sse["terminal"],
            "tokens": [f["token"] for f in frames],
            "unary_tokens": body["data"]["tokens"] if status == 201 else None}


class _DecodeRecorder:
    """A tokenizer that keeps the ids of its last ``decode``: the unary
    OpenAI answer carries text, and this gives its token ids."""

    def __init__(self, tok) -> None:
        self.tok, self.decoded = tok, None

    def encode(self, text: str, **kw) -> list:
        return self.tok.encode(text, **kw)

    def decode(self, ids) -> str:
        self.decoded = list(ids)
        return self.tok.decode(ids)

    def __getattr__(self, name: str):
        return getattr(self.tok, name)


def _warm_jax_form(dev, tmp: Path, cfg, econf, prompt: str, n_new: int,
                   tok, want: list) -> tuple:
    """``phase_serve_warm`` (d): a port ``App`` booted by JAX's text,
    ``warm_start(app, "llama3_8b", dir, build)``, on (a)'s checkpoint.
    ``want``: the in-memory engine's tokens for (b)'s BPE-encoded prompt
    (cold, then a prefix hit) and for the byte-encoded one (the same).
    On the card the text is JAX's to the letter; a CPU rehearsal
    (``dev`` the CPU) adds ``device=``. Returns (faults, planted faults
    caught, numbers)."""
    import asyncio
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.checkpoint import CheckpointError, warm_start
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.openai_compat import install_openai_routes

    ports = {"HTTP_PORT": "0", "METRICS_PORT": "0"}
    app = App(config=DictConfig({**ports, "APP_NAME": "warm-jax-form"}))
    recorder = _DecodeRecorder(tok)
    on_cpu = {"device": dev} if dev.type == "cpu" else {}

    def build(p):
        engine = llama_engine(p, cfg, econf,
                              metrics=app.container.metrics,
                              logger=app.logger, tracer=app.container.tracer,
                              **on_cpu)
        install_openai_routes(app=app, engine=engine, tokenizer=recorder,
                              model="llama3_8b",
                              render=lambda messages: messages[-1]["content"])
        return engine

    warm_start(app, "llama3_8b", tmp / "ckpt", build, **on_cpu)
    counters = (flash_attention, paged_decode_attention)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    loop, thread = _boot_app(app, "serve_warm (d)")
    boot_s = time.perf_counter() - t0
    faults = []
    try:
        port = app.http_server.bound_port
        chat = _warm_chat(port, prompt, n_new)
        status, body = _post(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            {"messages": [{"role": "user", "content": prompt}],
             "max_tokens": n_new, "temperature": 0})
        launches = {fn.__name__: int(fn.launches) for fn in counters}
        engine = app.container.models.get("llama3_8b")
    finally:
        _stop_app(app, loop, thread)
    if chat["status"] != 200 or not chat["terminal"]:
        faults.append(f"stream status {chat['status']}")
    if chat["tokens"] != want[2]:
        faults.append("streamed /chat tokens differ")
    if chat["unary_tokens"] != want[3]:
        faults.append("unary /chat tokens differ")
    if status not in (200, 201) or recorder.decoded != want[0]:
        faults.append(f"/v1/chat/completions: status {status}, tokens "
                      f"differ at {_common_prefix(recorder.decoded or [], want[0])}")
    bit_equal = not faults
    faults += [f"{name}: no launch" for name, n in launches.items() if n <= 0]
    if engine is None or engine.metrics is not app.container.metrics:
        faults.append("the engine is not on the app's metrics")

    # planted: an empty directory; the app's start must fail, naming it
    empty = App(config=DictConfig({**ports, "APP_NAME": "warm-empty"}))
    warm_start(empty, "llama3_8b", tmp / "empty", build, **on_cpu)

    async def boot_empty():
        try:
            await empty.start()
            cause = None
        except RuntimeError as exc:
            cause = exc.__cause__
        await empty.stop()
        return cause

    cause = asyncio.run(boot_empty())
    caught = isinstance(cause, CheckpointError) and "'llama3_8b'" in str(cause)
    first_token_s = boot_s + (chat["first_event_s"] or float("nan"))
    return faults, [repr(cause)[:200]] if caught else [], {
        "app_boot_s": boot_s, "app_start_to_first_token_s": first_token_s,
        "launches": launches, "stream_tokens": chat["tokens"][:8],
        "v1_completion_tokens": (body.get("usage") or {}).get(
            "completion_tokens"),
        "bit_equal": bit_equal, "planted_empty_dir": repr(cause)[:200]}


def phase_serve_warm(dev, smi_line: str, cfg=None, layers: int = 4,
                     text_bytes: int = WARM_TEXT_BYTES,
                     n_merges: int = WARM_MERGES) -> None:
    """Checkpoint/resume and warm start at Llama-3-8B's full width
    (``cfg``, default ``llama3_8b``: dim 4096, 32 / 8 heads, hd 128, ffn
    14336, vocab 128256, untied head) cut to ``layers`` of its 32 layers,
    random bf16 weights made on the card from seed 0, and the C++ BPE
    merge loop that tokenizes its prompts. Checks, each with a planted
    fault that must fail it:

    (a) ``Checkpointer.save`` from the card into a temporary directory,
        then ``restore(device=...)``: every leaf ``torch.equal`` to its
        source, stored as bf16 bits (the manifest's dtypes, and
        ``arrays.npz`` within 1 % of the weights' bytes: no float32
        copy); planted: one bf16 leaf round-tripped through float16;
    (b) ``warm_start`` builds the app's engine (``serve_config``) from
        the latest step behind ``build_server``: one streamed, then one
        unary greedy ``POST /chat`` of 32 tokens on the same prompt (the
        second a prefix-cache hit), bit for bit an in-memory
        ``llama_engine`` on the source tree with the same config serving
        the same two requests in order; planted: an engine built from the
        flat keystr-keyed dict (what the JAX package's hook passes),
        which must not serve;
    (d) JAX's call text on a port ``App``: ``warm_start(app,
        "llama3_8b", dir, build)``, ``build`` calling ``llama_engine(p,
        cfg, serve_config(cfg), metrics=app.container.metrics,
        logger=app.logger, tracer=app.container.tracer)`` and
        ``install_openai_routes(app=app, ...)``; the app's on-start hook
        restores (a)'s step and serves the engine. A streamed and a unary
        ``/chat`` (the byte tokenizer, which JAX's ``serve_model`` wires
        when given none) bit for bit the in-memory engine's on the
        byte-encoded prompt, a unary ``/v1/chat/completions`` on (b)'s
        BPE-encoded prompt bit for bit (b)'s first request; the flash
        and paged decode kernels' launches over (d) both > 0; planted:
        an ``App`` warm-started from an empty directory, whose start must
        fail with ``CheckpointError`` naming ``llama3_8b``;
    (c) a ``tokenizer.json`` with ``n_merges`` merges learned from a
        seeded synthetic corpus, loaded by ``BPETokenizer.from_hf_json``:
        the native loop must be live (a fallback fails), its ids on
        ``text_bytes`` of seeded text equal the pure-Python loop's, and
        ``decode(encode(t)) == t``; planted: two merge ranks swapped in
        the native table alone. The same tokenizer serves (b)'s prompts.

    Also the bytes, ``save_s``, ``restore_s`` and GB/s of each, the
    seconds from ``restore_engine`` (b) and from the ``App``'s start (d)
    to the first token, peak memory, and the encode MB/s of the native
    and the pure-Python loop."""
    import copy
    import shutil
    import tempfile
    import numpy as np
    import torch
    from gofr_tpu_torch.checkpoint import (ARRAYS, MANIFEST, Checkpointer,
                                           flatten, restore_engine)
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                             param_count)
    from gofr_tpu_torch.native.bpe import NativeBPE
    from gofr_tpu_torch.serving.app import build_server, serve_config
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.tokenizer import (BPETokenizer,
                                                  ByteTokenizer,
                                                  _byte_level_table)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="gofr_warm_"))
    reduced = []
    checks: dict = {}
    out: dict = {"phase": "serve_warm", "card": smi_line}
    try:
        # (c) first: its tokenizer feeds (b)'s prompts
        rng = np.random.default_rng(0)
        words = _warm_words(rng, 3000)
        t0 = time.perf_counter()
        merges = _learn_merges(_warm_text(rng, words, 200_000), n_merges)
        learn_s = time.perf_counter() - t0
        _write_learned_tokenizer(tmp / "tokenizer.json", merges)
        tok = BPETokenizer.from_hf_json(tmp / "tokenizer.json")
        text = _warm_text(np.random.default_rng(1), words, text_bytes)
        data_mb = len(text.encode()) / 1e6
        py = copy.copy(tok)
        py._native = None
        c_faults = [] if tok.native else ["native loop not live"]
        t0 = time.perf_counter()
        ids = tok.encode(text, bos=False)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py_ids = py.encode(text, bos=False)
        py_s = time.perf_counter() - t0
        if ids != py_ids:
            c_faults.append(f"ids differ at {_common_prefix(ids, py_ids)}")
        if tok.decode(ids) != text:
            c_faults.append("decode(encode(text)) != text")
        swapped = dict(tok.merge_ranks)
        first, last = merges[0].replace(" ", ""), merges[-1].replace(" ", "")
        byte = _byte_level_table()
        first_b = bytes(byte[c] for c in first)
        last_b = bytes(byte[c] for c in last)
        swapped[first_b], swapped[last_b] = swapped[last_b], swapped[first_b]
        bad = copy.copy(tok)
        bad._native = NativeBPE(tok.ranks, swapped) if tok.native else None
        bad_ids = bad.encode(text, bos=False)
        checks["c_native_bpe"] = (c_faults, [] if bad_ids == ids else [
            f"ids differ at {_common_prefix(ids, bad_ids)}"])
        out["c"] = {"merges": len(merges), "learn_s": learn_s,
                    "text_mb": data_mb, "tokens": len(ids),
                    "native": tok.native, "native_s": native_s,
                    "python_s": py_s, "native_mb_s": data_mb / native_s,
                    "python_mb_s": data_mb / py_s,
                    "planted_first_diff": _common_prefix(ids, bad_ids)}

        # (a) save and restore at full width
        cfg = cfg or LlamaConfig.llama3_8b()
        need = None
        for n in (layers, 2):
            c = cfg.scaled(n_layers=n)
            need = 2 * (2 * c.vocab_size * c.dim + n * (
                c.dim * (c.n_heads + 2 * c.n_kv_heads) * c.head_dim
                + c.n_heads * c.head_dim * c.dim + 3 * c.dim * c.ffn_dim))
            if shutil.disk_usage(tmp).free > 1.2 * need or n == 2:
                break
        if n != cfg.n_layers:
            reduced.append(f"depth {n} of {cfg.n_layers} layers")
            if n != layers:
                reduced.append(f"{layers} layers do not fit the disk")
        cfg = cfg.scaled(n_layers=n)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = llama_init(cfg, gen, dev)
        nbytes = sum(v.numel() * v.element_size()
                     for _, v in flatten(params))
        ckpt = Checkpointer(tmp / "ckpt")
        sync()
        t0 = time.perf_counter()
        ckpt.save(1, params, metadata={"config": "llama3_8b",
                                       "n_layers": n})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = ckpt.restore(device=dev)
        sync()
        restore_s = time.perf_counter() - t0
        want = dict(flatten(params))
        manifest = json.loads((tmp / "ckpt" / "step_1" / MANIFEST)
                              .read_text())
        stored = (tmp / "ckpt" / "step_1" / ARRAYS).stat().st_size
        a_faults = _leaf_faults(restored, want)
        a_faults += [e["key"] for e in manifest["leaves"]
                     if e["dtype"] != "bfloat16"]
        if not nbytes <= stored <= 1.01 * nbytes:
            a_faults.append(f"arrays.npz {stored} B for {nbytes} B of bf16")
        planted = dict(restored)
        planted["['embed']"] = planted["['embed']"].to(
            torch.float16).to(torch.bfloat16)
        checks["a_roundtrip"] = (a_faults, _leaf_faults(planted, want))
        del planted
        out["config"] = (f"llama3_8b: dim {cfg.dim}, {cfg.n_heads} / "
                         f"{cfg.n_kv_heads} heads, hd {cfg.head_dim}, ffn "
                         f"{cfg.ffn_dim}, vocab {cfg.vocab_size}, "
                         f"{cfg.n_layers} layers, {cfg.dtype}, seed 0")
        out["a"] = {"params": param_count(params), "bytes": nbytes,
                    "stored_bytes": stored, "save_s": save_s,
                    "restore_s": restore_s,
                    "save_gb_s": nbytes / save_s / 1e9,
                    "restore_gb_s": nbytes / restore_s / 1e9}

        # (b) warm start behind the app, against the in-memory engine
        econf = serve_config(cfg)
        prompt = text[:600]
        n_new = 32
        flat = restored
        del restored
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = restore_engine("llama3_8b", tmp / "ckpt",
                                lambda p: llama_engine(p, cfg, econf,
                                                       device=dev),
                                device=dev)
        server = build_server(engine, tok, port=0)
        thread = _serving(server)
        try:
            started = time.perf_counter() - t0
            chat = _warm_chat(server.port, prompt, n_new)
        finally:
            _stop(server, thread)
            engine.stop()
        first_token_s = started + (chat["first_event_s"] or float("nan"))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
        del engine, server
        gc.collect()
        # the same two requests in the same order: the second one hits
        # the prefix cache, in the app and here; then (d)'s pair on the
        # byte-encoded prompt (no page in common with the first two)
        byte_ids = ByteTokenizer().encode(prompt)
        twin = llama_engine(params, cfg, econf, device=dev)
        twin.start()
        try:
            reqs = [twin.submit_sync(ids, SamplingParams(
                temperature=0.0, max_new_tokens=n_new), 600)
                for ids in [tok.encode(prompt)] * 2 + [byte_ids] * 2]
        finally:
            twin.stop()
        del twin
        req = reqs[0]
        b_faults = []
        if chat["status"] != 200 or not chat["terminal"]:
            b_faults.append(f"stream status {chat['status']}")
        if any(r.error or len(r.generated) != n_new for r in reqs):
            b_faults.append(f"in-memory engine: {[r.error for r in reqs]}")
        if chat["tokens"] != list(req.generated):
            b_faults.append("streamed tokens differ")
        if chat["unary_tokens"] != list(reqs[1].generated):
            b_faults.append("unary tokens differ")
        # planted: the flat dict the JAX hook passes
        try:
            wrong = llama_engine(flat, cfg, econf, device=dev)
            wrong.start()
            try:
                bad_req = wrong.submit_sync(tok.encode(prompt),
                                            SamplingParams(
                                                temperature=0.0,
                                                max_new_tokens=n_new), 600)
            finally:
                wrong.stop()
            served = bad_req.error is None and bool(bad_req.generated)
            flat_error = bad_req.error
            del wrong
        except Exception as exc:  # noqa: BLE001 — refusing to build fails it
            served, flat_error = False, repr(exc)[:200]
        checks["b_warm_start"] = (b_faults, [] if served else [
            f"the flat dict did not serve: {flat_error}"])
        # (d) JAX's call text on the port's App
        t_d = time.perf_counter()
        d_faults, d_planted, out["d"] = _warm_jax_form(
            dev, tmp, cfg, econf, prompt, n_new, tok,
            [list(r.generated) for r in reqs])
        out["d"]["d_wall_s"] = time.perf_counter() - t_d
        checks["d_jax_warm_start"] = (d_faults, d_planted)
        out["b"] = {"engine": f"serve_config: {econf.max_batch} slots, "
                              f"max_seq {econf.max_seq}, page "
                              f"{econf.page_size}",
                    "prompt_tokens": len(tok.encode(prompt)),
                    "warm_start_to_server_s": started,
                    "warm_start_to_first_token_s": first_token_s,
                    "tokens": chat["tokens"][:8],
                    "in_memory_tokens": list(req.generated)[:8],
                    "bit_equal": chat["tokens"] == list(req.generated)
                    and chat["unary_tokens"] == list(reqs[1].generated),
                    "prefix_hit_tokens_equal_first": list(
                        reqs[1].generated) == list(req.generated),
                    "max_memory_allocated_gb": peak,
                    "planted_flat_error": flat_error}
        del flat, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"reduced": reduced,
                "phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_warm: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")


APP_NEW = 64
APP_DRAIN_NEW = 256
APP_KEY = "smoke-key"
APP_TENANT = "smoke-team"


def _app_prompts(tag: str = "") -> list:
    """``serve_app``'s wave: 8 prompts of 21 to 901 byte tokens and one
    of 1501 (wider than the 1024 bucket: it walks through the chunk
    kernel), each led by ``tag``, so waves with different tags share no
    prefix-cache page."""
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")
    return ([(tag + words * 20)[:n] for n in
             (20, 45, 90, 150, 260, 400, 610, 900)]
            + [(tag + story * 30)[:1500]])


def _pcts(values: list) -> dict:
    import numpy as np
    if not values:
        return {"p50": None, "p99": None}
    return {"p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99))}


def _sse_timing(runs: list) -> dict:
    """Client TTFT (the first token event, s after the send) p50 / p99,
    the gaps between the reads that brought token events p50 / p99 (ms;
    the events of one read share its time: a pass's tokens arrive
    together), and decode tokens/s: tokens after each stream's first,
    over the span from the earliest first token to the latest last
    one."""
    ttft, gaps, firsts, lasts, after_first = [], [], [], [], 0
    for run in runs:
        times = [t for t, e in run["events"]
                 if isinstance(e, dict) and "token" in e]
        if not times:
            continue
        ttft.append(times[0])
        reads = sorted(set(times))
        gaps += [(b - a) * 1000.0 for a, b in zip(reads, reads[1:])]
        firsts.append(times[0] + run["sent_at"])
        lasts.append(times[-1] + run["sent_at"])
        after_first += len(times) - 1
    span = max(lasts) - min(firsts) if firsts else 0.0
    return {"ttft_s": _pcts(ttft), "sse_gap_ms": _pcts(gaps),
            "decode_tokens_per_s": after_first / span if span > 0 else None,
            "streams": len(ttft)}


def _alive_health_faults(alive: tuple, health: tuple, gpu: str) -> list:
    """(a): alive 200 UP; health 200 UP naming the served engine (UP)
    and the card among its devices."""
    out = []
    if alive[0] != 200 or alive[2] != {"data": {"status": "UP"}}:
        out.append(f"alive {alive[0]}")
    data = health[2].get("data") or {}
    tpu = (data.get("checks") or {}).get("tpu") or {}
    details = tpu.get("details") or {}
    if health[0] != 200 or data.get("status") != "UP":
        out.append(f"health {health[0]} {data.get('status')}")
    if ((details.get("engines") or {}).get("llama") or {}).get(
            "status") != "UP":
        out.append("engine not named UP")
    if gpu not in [d.get("kind") for d in details.get("devices") or []]:
        out.append("card not named")
    return out


def _wave_faults(answers: list, reqs: list, ref: list, ref_reqs: list,
                 n_new: int) -> list:
    """(b): every unary answer 201 with ``n_new`` tokens, each equal to
    the reference run's, and every request's digest the reference's."""
    out = []
    for i, (a, r) in enumerate(zip(answers, ref)):
        if a[0] != 201 or len(a[2]["data"]["tokens"]) != n_new:
            out.append(f"answer_{i}")
        elif a[2]["data"]["tokens"] != r[2]["data"]["tokens"]:
            out.append(f"tokens_{i}")
    if len(reqs) != len(ref_reqs) or [r.digest for r in reqs] != [
            r.digest for r in ref_reqs] or None in [r.digest for r in reqs]:
        out.append("digests")
    return out


def _app_stream_faults(streams: list, unary: list) -> list:
    """(c): each ``/chat`` stream's frame tokens are its prompt's unary
    tokens, then ``[DONE]`` and the zero-length chunk."""
    out = []
    for i, (s, u) in enumerate(zip(streams, unary)):
        frames = [e["token"] for _, e in s["events"]
                  if isinstance(e, dict) and "token" in e]
        if frames != u[2]["data"]["tokens"]:
            out.append(f"frames_{i}")
        if not s["events"] or s["events"][-1][1] != "[DONE]" \
                or not s["terminal"]:
            out.append(f"done_{i}")
    return out


def _v1_faults(streams: list, s_reqs: list, unary: list,
               u_reqs: list) -> list:
    """(c): the ``/v1/chat/completions`` streams generated the unary
    completions' tokens (their requests' tokens and digests), well
    formed, their deltas joined the unary text."""
    out = []
    for i, (s, u) in enumerate(zip(streams, unary)):
        text = "".join(t for t in (_content(e) for _, e in s["events"])
                       if t is not None)
        if u[0] != 201 or text != u[2]["choices"][0]["message"]["content"]:
            out.append(f"text_{i}")
        out += [f"{f}_{i}" for f in _form_faults(s, chat=True)]
    if [list(r.generated) for r in s_reqs] != [
            list(r.generated) for r in u_reqs] \
            or [r.digest for r in s_reqs] != [r.digest for r in u_reqs]:
        out.append("tokens")
    return out


def _app_trace_faults(names: set) -> list:
    """(d): the trace taken through the app names the flash, paged
    decode, paged chunk and fused RoPE + K/V write kernels."""
    return [f"no {k} kernel" for k in ("flash", "paged_decode",
                                       "paged_chunk", "rope_kv_write")
            if not any(k in n for n in names)]


def _auth_faults(no_key: tuple, bad_key: tuple, good: list) -> list:
    """(e): no key and a wrong key 401 ``ApiKey``; a good key 201 with
    the resolver's tenant label in ``usage``."""
    out = []
    for name, a in (("no_key", no_key), ("bad_key", bad_key)):
        if a[0] != 401 or a[1].get("www-authenticate") != "ApiKey":
            out.append(name)
    if any(a[0] != 201 or a[2]["data"]["usage"]["tenant"] != APP_TENANT
           for a in good):
        out.append("tenant")
    return out


def _app_metrics_faults(text: str) -> list:
    """(f): the HTTP histogram labelled by route pattern (``/chat``; an
    unmatched path as ``<unmatched>``, never its raw path), the engine
    gauges and at least one GPU."""
    out = []
    lines = text.splitlines()
    http = [ln for ln in lines if ln.startswith("app_http_response_count{")]
    if not any('path="/chat"' in ln for ln in http):
        out.append("no /chat label")
    if not any('path="<unmatched>"' in ln for ln in http) \
            or any('path="/nope/123"' in ln for ln in http):
        out.append("raw path label")
    for name in ("app_engine_active_slots", "app_engine_kv_pool_utilization",
                 "app_engine_tokens_per_second"):
        if not any(ln.startswith(name) for ln in lines):
            out.append(f"no {name}")
    count = [float(ln.split()[-1]) for ln in lines
             if ln.startswith("app_gpu_device_count")]
    if not count or count[0] < 1:
        out.append("app_gpu_device_count")
    return out


def _drain_faults(run: dict) -> list:
    """(g): the 4 requests in flight complete, the one sent during the
    drain gets a 503 ``draining`` with ``Retry-After``, the engine and
    the app stop."""
    out = []
    if any(a is None or a[0] != 201
           or len(a[2]["data"]["tokens"]) != APP_DRAIN_NEW
           for a in run["in_flight"]):
        out.append("in_flight")
    refused = run["refused"]
    if refused is None or refused[0] != 503 \
            or not refused[1].get("retry-after", "").isdigit() \
            or ((refused[2].get("error") or {}).get("details") or {}).get(
                "code") != "draining":
        out.append("refused")
    if run["engine_running"] or not run["app_stopped"]:
        out.append("stopped")
    return out


def _launch_faults(launches: dict) -> list:
    """The path's kernels each launched at least once."""
    return [f"{k} not launched" for k, n in launches.items() if n < 1]


def phase_serve_app(dev, smi_line: str) -> dict:
    """The framework surface on the card: ``serving/model_serving.
    build_app`` (``App.serve_model`` + ``install_openai_routes``) with
    ``MODEL_PRESET=llama3_1b`` (full width and depth, random bf16 weights
    from seed 0, ``serve_config``: 8 slots, prefix cache on),
    ``PROFILER_ENABLED=1`` and API-key auth, on an event loop in a
    thread; beside it ``build_server`` (the ``ChatServer``) on the same
    engine. Greedy throughout; every request the handlers submit is
    recorded. A gated wave stops the engine, queues its requests in order
    and starts it, so both servers' waves are admitted alike on an empty
    prefix cache. Checks, each also shown a planted fault it must reject:

    (a) ``/.well-known/alive`` 200 UP; ``/.well-known/health`` 200 UP,
        the engine ``llama`` UP and the card named among the devices;
        planted: the device list emptied.
    (b) the wave (8 prompts of 21-901 tokens and one of 1501, walked
        through the chunk kernel; 64 new tokens) as unary ``/chat``,
        gated, App / ChatServer / ChatServer / App: every answer's
        tokens and every request's digest equal across the four;
        planted: one token id changed.
    (c) the wave streamed on ``/chat`` through the app: frame tokens =
        (b)'s; ``/v1/chat/completions`` unary and streamed: the same
        tokens and digests, well-formed streams, deltas = the text; a
        ``/chat`` stream whose client closes after 3 tokens frees its
        slot within 2 s (the slot's samples), fewer than 128 tokens
        decoded; planted: a frame dropped.
    (d) a ``/debug/profile/start`` .. ``stop`` capture through the app
        around one ungated unary wave: the trace names the flash, paged
        decode, paged chunk and ``rope_kv_write`` kernels; planted: an
        idle capture.
    (e) no key and a wrong key: 401 ``ApiKey``; the good key: 201 with
        usage tenant ``smoke-team``; planted: the wrong key's answer
        replaced by a 201.
    (f) the metrics port: ``app_http_response`` labelled ``/chat`` and
        ``<unmatched>`` (for ``/nope/123``), the ``app_engine_*`` gauges,
        ``app_gpu_device_count`` >= 1; planted: the raw path label.
    (g) ``App._graceful_stop`` with 4 requests of 256 tokens in flight:
        all 4 complete, a request during the drain gets 503 ``draining``
        with ``Retry-After``, the engine and the app stop; planted: one
        of the 4 cut short.

    Also, ungated (unique prompts, engine running), 8 ``/chat`` streams
    at once, App / ChatServer / ChatServer / App: client TTFT p50 / p99
    beside the engine's, the gaps between token events p50 / p99, decode
    tokens/s; and the
    launch counters, zeroed before the first wave and read after (g):
    flash, paged decode, paged chunk and ``rope_kv_write`` must rise."""
    import asyncio
    import copy
    import shutil
    import tempfile
    import torch
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write
    from gofr_tpu_torch.serving import model_serving
    from gofr_tpu_torch.serving.app import build_server
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    gpu = torch.cuda.get_device_name(0) if cuda else "cpu"
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "rope_kv_write": rope_kv_write}
    checks: dict = {}
    out: dict = {"phase": "serve_app", "card": smi_line}
    key = {"X-Api-Key": APP_KEY}
    greedy = {"max_tokens": APP_NEW, "temperature": 0}
    tmp = tempfile.mkdtemp(prefix="serve_app_")
    app = model_serving.build_app(DictConfig({
        "MODEL_PRESET": "llama3_1b", "HTTP_HOST": "127.0.0.1",
        "HTTP_PORT": "0", "METRICS_PORT": "0", "PROFILER_ENABLED": "1",
        "PROFILER_DIR": tmp, "APP_NAME": "serve-app"}), device=dev)
    app.enable_api_key_auth(APP_KEY, key_names={APP_KEY: APP_TENANT})
    engine = app.container.get_model(model_serving.MODEL_NAME)
    made: list = []
    inner_submit = engine.submit

    def submit(*args, **kwargs):
        made.append(inner_submit(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    loop = asyncio.new_event_loop()
    booted, boot_error = threading.Event(), []

    def run_loop():
        asyncio.set_event_loop(loop)

        async def main():
            try:
                await app.start()
            except BaseException as exc:  # noqa: BLE001 — reported below
                boot_error.append(exc)
                raise
            finally:
                booted.set()
            await app._stop_event.wait()

        try:
            loop.run_until_complete(main())
        except BaseException:  # noqa: BLE001 — boot_error holds it
            pass

    loop_thread = threading.Thread(target=run_loop, daemon=True)
    loop_thread.start()
    if not booted.wait(600) or boot_error:
        raise AssertionError(f"serve_app: the app did not boot {boot_error}")
    aport = app.port
    # one metrics manager, logger and tracer for both servers: the
    # engine's series stay on the app's metrics port
    server = build_server(engine, ByteTokenizer(), port=0, name="llama",
                          env={}, metrics=app.container.metrics,
                          logger=app.logger, tracer=app.container.tracer)
    server_thread = threading.Thread(target=server.serve_forever,
                                     daemon=True)
    server_thread.start()
    sport = server.server_address[1]

    def gated(port, asks, headers=None):
        """``asks`` ((path, body, stream) each) queued in order on the
        stopped engine, then the engine started: (answers, requests)."""
        engine.stop()
        engine.waiting.reopen()
        base = len(made)
        got: list = [None] * len(asks)

        def call(i, path, body, stream):
            got[i] = (_sse_call(port, path, body, headers=headers) if stream
                      else _http_json(port, "POST", path, body, headers))

        workers = []
        for i, ask in enumerate(asks):
            workers.append(threading.Thread(target=call, args=(i, *ask)))
            workers[-1].start()
            deadline = time.time() + 60
            while len(made) < base + i + 1 and time.time() < deadline:
                time.sleep(0.001)
        engine.start()
        for w in workers:
            w.join(timeout=600)
        return got, made[base:]

    def at_once(port, asks, headers=None):
        """``asks`` sent together to the running engine."""
        got: list = [None] * len(asks)

        def call(i, path, body, stream):
            got[i] = (_sse_call(port, path, body, headers=headers) if stream
                      else _http_json(port, "POST", path, body, headers))

        workers = [threading.Thread(target=call, args=(i, *a))
                   for i, a in enumerate(asks)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        return got

    try:
        # (a) before any traffic
        alive = _http_json(aport, "GET", "/.well-known/alive")
        health = _http_json(aport, "GET", "/.well-known/health")
        bare = copy.deepcopy(health)
        bare[2]["data"]["checks"]["tpu"]["details"]["devices"] = []
        checks["a_alive_health"] = (_alive_health_faults(alive, health, gpu),
                                    _alive_health_faults(alive, bare, gpu))
        out["a"] = {"health_status": health[2]["data"]["status"],
                    "devices": [d.get("kind") for d in health[2]["data"][
                        "checks"]["tpu"]["details"]["devices"]]}
        for fn in counters.values():
            fn.launches = 0
        prompts = _app_prompts()
        chat = [("/chat", {"prompt": p, **greedy}, False) for p in prompts]
        # (b) App / ChatServer / ChatServer / App, gated
        runs = []
        for side in ("app", "server", "server", "app"):
            runs.append(gated(aport if side == "app" else sport, chat,
                              key if side == "app" else None))
        ref, ref_reqs = runs[0]
        b_faults = []
        for i, (answers, reqs) in enumerate(runs[1:], 1):
            b_faults += [f"run{i}_{f}" for f in
                         _wave_faults(answers, reqs, ref, ref_reqs, APP_NEW)]
        bent = copy.deepcopy(runs[1][0])
        bent[0][2]["data"]["tokens"][5] ^= 1
        checks["b_unary_wave"] = (
            _wave_faults(ref, ref_reqs, ref, ref_reqs, APP_NEW) + b_faults,
            _wave_faults(bent, runs[1][1], ref, ref_reqs, APP_NEW))
        out["b"] = {"prompt_tokens": [len(r.prompt_tokens) for r in ref_reqs],
                    "tokens_0": ref[0][2]["data"]["tokens"][:8],
                    "digests_equal": not b_faults}
        # (c) streams through the app, gated
        streams, _ = gated(aport, [(p, {**b, "stream": True}, True)
                                   for p, b, _ in chat], key)
        cut = copy.deepcopy(streams)
        del cut[0]["events"][3]
        v1 = [("/v1/chat/completions",
               {"messages": [{"role": "user", "content": p}], **greedy},
               False) for p in prompts[:4]]
        v1_unary, v1_u_reqs = gated(aport, v1, key)
        v1_sse, v1_s_reqs = gated(aport, [(p, {**b, "stream": True}, True)
                                          for p, b, _ in v1], key)
        # a client that leaves: the slot's samples after its close
        since = len(made)
        closer = _sse_call(aport, "/chat", {"prompt": prompts[2],
                                            "max_tokens": 1024,
                                            "temperature": 0,
                                            "stream": True},
                           close_after=3, headers=key)
        samples = _watch_slots(engine, 5.0, closer["closed_at"])
        left = made[since]
        leave_faults = _freed_faults(samples, 2.0) + (
            [] if left.cancelled and len(left.generated) < 128
            else ["not cancelled"])
        checks["c_streams"] = (
            _app_stream_faults(streams, ref) + _v1_faults(
                v1_sse, v1_s_reqs, v1_unary, v1_u_reqs) + leave_faults,
            _app_stream_faults(cut, ref))
        out["c"] = {"left_tokens": len(left.generated),
                    "left_freed_s": next((t for t, b in samples if b == 0),
                                         None)}
        # ungated timing, unique prompts: App / ChatServer / ChatServer / App
        timing = {"app": [], "server": []}
        for i, side in enumerate(("app", "server", "server", "app")):
            asks = [("/chat", {"prompt": p, **greedy, "stream": True}, True)
                    for p in _app_prompts(f"t{i} ")[:8]]
            base = len(made)
            run = _sse_timing(at_once(aport if side == "app" else sport,
                                      asks, key if side == "app" else None))
            # the engine's own TTFT (submit to first token): what the
            # client's adds to it is the server's
            run["engine_ttft_s"] = _pcts([r.ttft_ms / 1000.0
                                          for r in made[base:]
                                          if r.ttft_ms is not None])
            timing[side].append(run)
        out["timing"] = {**timing, "card": smi_line,
                         "definition": "8 /chat streams sent at once, 64 "
                         "tokens each, prompts 21-901 tokens; TTFT from the "
                         "send to the first token event"}
        # (d) a capture through the app's own routes around one wave
        started = _http_json(aport, "POST", "/debug/profile/start", {}, key)
        profiled = at_once(aport, [("/chat", {"prompt": p, **greedy}, False)
                                   for p in _app_prompts("p ")], key)
        stopped = _http_json(aport, "POST", "/debug/profile/stop", {}, key)
        trace = Path((stopped[2].get("data") or {}).get("dir") or "") \
            / "trace.json"
        names = {n for n in _trace_kernel_names(str(trace))
                 if any(k in n for k in ("paged", "rope_kv", "flash"))}
        _http_json(aport, "POST", "/debug/profile/start", {}, key)
        time.sleep(0.3)
        idle = _http_json(aport, "POST", "/debug/profile/stop", {}, key)
        idle_names = _trace_kernel_names(str(Path(
            (idle[2].get("data") or {}).get("dir") or "") / "trace.json"))
        checks["d_trace"] = (
            _app_trace_faults(names) + [
                f"profiled {i}" for i, a in enumerate(profiled)
                if a[0] != 201] + ([] if started[0] == 201 else ["start"]),
            _app_trace_faults(idle_names))
        out["d"] = {"kernel_names": sorted(names),
                    "trace_mb": (trace.stat().st_size / 2 ** 20
                                 if trace.exists() else None)}
        # (e) auth
        body = {"prompt": prompts[0], **greedy}
        no_key = _http_json(aport, "POST", "/chat", body)
        bad_key = _http_json(aport, "POST", "/chat", body,
                             {"X-Api-Key": "not-the-key"})
        accepted = (201, {}, ref[0][2])
        checks["e_auth"] = (_auth_faults(no_key, bad_key, ref),
                            _auth_faults(no_key, accepted, ref))
        out["e"] = {"no_key": no_key[0], "bad_key": bad_key[0],
                    "tenant": ref[0][2]["data"]["usage"]["tenant"]}
        # (f) metrics
        _http_json(aport, "GET", "/nope/123", None, key)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{app.metrics_server.bound_port}/metrics",
                timeout=60) as resp:
            text = resp.read().decode()
        checks["f_metrics"] = (_app_metrics_faults(text), _app_metrics_faults(
            text.replace('path="<unmatched>"', 'path="/nope/123"')))
        # (g) the drain, with 4 requests in flight
        server.shutdown()
        server.server_close()
        since = len(made)
        drain_asks = [("/chat", {"prompt": p, "max_tokens": APP_DRAIN_NEW,
                                 "temperature": 0}, False)
                      for p in _app_prompts("g ")[:4]]
        in_flight: list = [None] * 4

        def flight(i, path, body, stream):
            in_flight[i] = _http_json(aport, "POST", path, body, key)

        flights = [threading.Thread(target=flight, args=(i, *a))
                   for i, a in enumerate(drain_asks)]
        for f in flights:
            f.start()
        deadline = time.time() + 120
        while time.time() < deadline and not (
                len(made) >= since + 4
                and all(r.generated for r in made[since:since + 4])):
            time.sleep(0.002)
        stopping = asyncio.run_coroutine_threadsafe(app._graceful_stop(),
                                                    loop)
        deadline = time.time() + 30
        while not engine._draining and time.time() < deadline:
            time.sleep(0.001)
        refused = _http_json(aport, "POST", "/chat", body, key) \
            if engine._draining else None
        stopping.result(timeout=120)
        for f in flights:
            f.join(timeout=120)
        loop_thread.join(timeout=30)
        drain = {"in_flight": in_flight, "refused": refused,
                 "engine_running": engine._running,
                 "app_stopped": app._stop_event.is_set()}
        cut_short = copy.deepcopy(drain)
        cut_short["in_flight"][1] = refused
        checks["g_drain"] = (_drain_faults(drain), _drain_faults(cut_short))
        out["g"] = {"in_flight_status": [a[0] if a else None
                                         for a in in_flight],
                    "refused": None if refused is None else refused[0],
                    "retry_after": None if refused is None
                    else refused[1].get("retry-after")}
        launches = {name: int(fn.launches) for name, fn in counters.items()}
        checks["launches"] = (_launch_faults(launches),
                              _launch_faults(dict.fromkeys(launches, 0)))
        out["launches"] = launches
    finally:
        engine.submit = inner_submit
        if loop.is_running():
            asyncio.run_coroutine_threadsafe(app.stop(), loop).result(60)
        loop_thread.join(timeout=30)
        if not loop.is_running():
            loop.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del app, engine, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_app: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out["launches"]


WS_NEW = 64
WS_MORE = ("every socket carries one conversation while the engine batches "
           "them into one decode pass a step ")


def _ws_prompts(tag: str = "") -> list:
    """``serve_ws``'s wave: ``serve_app``'s nine prompts (eight of 21-901
    byte tokens, one of 1501 walked through the chunk kernel) and seven
    more of 26-761 tokens, each led by ``tag``."""
    return _app_prompts(tag) + [(tag + WS_MORE * 20)[:n] for n in
                                (25, 60, 110, 190, 320, 500, 760)]


@dataclasses.dataclass
class Conversation:
    """``serve_ws``'s CRUD entity: one row per answered socket message."""
    id: int
    socket: str
    prompt_tokens: int
    n_generated: int
    digest: str


def _ws_migrations(planted: bool = False) -> dict:
    """Version 1 makes the ``conversation`` table, version 2 sets a redis
    key; with ``planted`` a version 3 makes a table, reads it back inside
    its transaction and raises."""
    from gofr_tpu_torch.migrations import Migrate

    def v1(ds):
        ds.sql.exec("CREATE TABLE conversation (id INTEGER PRIMARY KEY, "
                    "socket TEXT, prompt_tokens INTEGER, n_generated "
                    "INTEGER, digest TEXT)")

    def v2(ds):
        ds.redis.set("ws_chat:schema", "2")

    out = {1: Migrate(up=v1), 2: Migrate(up=v2)}
    if planted:
        def v3(ds):
            ds.sql.exec("CREATE TABLE archive (id INTEGER)")
            _WS_INSIDE.update(_sql_state(ds.sql))
            raise RuntimeError("planted: version 3 fails")
        out[3] = Migrate(up=v3)
    return out


#: what version 3 saw inside its transaction, before it raised
_WS_INSIDE: dict = {}


def _sql_state(sql) -> dict:
    """The tables and the migration ledger the SQL handle sees."""
    return {"tables": sorted(r["name"] for r in sql.query(
                "SELECT name FROM sqlite_master WHERE type = 'table'")),
            "ledger": [r["version"] for r in sql.query(
                "SELECT version FROM gofr_migrations ORDER BY version")]}


def _migrate_faults(run: dict) -> list:
    """(a): versions 1 and 2 applied once, none the second time, version
    3's raise rolled back (no ``archive`` table, no ledger row 3, in SQL
    or redis), the schema key in redis."""
    out = []
    if run["first"] != [1, 2] or run["again"] != []:
        out.append(f"applied {run['first']} then {run['again']}")
    if not run["v3_raised"]:
        out.append("v3 did not raise")
    state = run["after"]
    if "conversation" not in state["tables"] or "archive" in state["tables"]:
        out.append(f"tables {state['tables']}")
    if state["ledger"] != [1, 2] or run["redis_ledger"] != [
            "gofr_migrations:1", "gofr_migrations:2"]:
        out.append(f"ledger {state['ledger']} {run['redis_ledger']}")
    if run["schema_key"] != "2":
        out.append("redis schema key")
    return out


def _ws_health_faults(health: tuple) -> list:
    """(a): health 200 UP with ``sql``, ``redis`` and the engine ``llama``
    UP."""
    data = health[2].get("data") or {}
    checks = data.get("checks") or {}
    out = [] if health[0] == 200 and data.get("status") == "UP" \
        else [f"health {health[0]} {data.get('status')}"]
    for name in ("sql", "redis"):
        if (checks.get(name) or {}).get("status") != "UP":
            out.append(f"{name} not UP")
    engines = ((checks.get("tpu") or {}).get("details") or {}).get(
        "engines") or {}
    if (engines.get("llama") or {}).get("status") != "UP":
        out.append("engine not UP")
    return out


async def _ws_ask(port: int, body, close_after: int | None = None,
                  sent=None, hold: bool = False) -> dict:
    """One message over a fresh socket to ``/ws/chat``: the frames with
    their arrival times (s after the send) until the closing frame, which
    is ``done``. With ``close_after`` the client closes once that many
    token frames came (``closed_at``: ``time.perf_counter()`` then), or
    with ``hold`` stops reading and keeps the socket open (``conn``).
    ``sent`` is set once the message is out."""
    from gofr_tpu_torch.websocket import connect
    conn = await connect(f"ws://127.0.0.1:{port}/ws/chat", timeout=60)
    out = {"frames": [], "done": None, "closed_at": None, "conn": None}
    await conn.send(body)
    t0 = time.perf_counter()
    out["sent_at"] = time.time()
    if sent is not None:
        sent.set()
    try:
        while True:
            message = await conn.recv()
            if message is None:
                break
            frame = json.loads(message.text())
            if "token" not in frame:
                out["done"] = frame
                break
            out["frames"].append((time.perf_counter() - t0, frame))
            if close_after is not None and len(out["frames"]) >= close_after:
                if hold:
                    out["conn"] = conn
                    return out
                out["closed_at"] = time.perf_counter()
                break
    finally:
        if out["conn"] is None:
            await conn.close()
    return out


def _ws_tokens(run: dict) -> list:
    return [f["token"] for _, f in run["frames"]]


def _ws_wave_faults(socks: list, ws_reqs: list, unary: list,
                    u_reqs: list) -> list:
    """(b): every socket's token frames are its prompt's unary ``/chat``
    tokens (``WS_NEW`` of them), its closing frame counts them and names
    its request's digest, and every request digest equals the unary
    wave's."""
    out = []
    for i, (s, u) in enumerate(zip(socks, unary)):
        tokens = _ws_tokens(s)
        if u[0] != 201 or len(u[2]["data"]["tokens"]) != WS_NEW:
            out.append(f"unary_{i}")
        elif tokens != u[2]["data"]["tokens"]:
            out.append(f"frames_{i}")
        done = s["done"] or {}
        if done.get("done") != len(tokens) or (
                i < len(ws_reqs) and done.get("digest") != ws_reqs[i].digest):
            out.append(f"done_{i}")
    if len(socks) != len(unary) or len(ws_reqs) != len(u_reqs) or None in [
            r.digest for r in ws_reqs] or [r.digest for r in ws_reqs] != [
            r.digest for r in u_reqs]:
        out.append("digests")
    return out


def _ws_store_faults(socks: list, rows: dict, texts: dict, decode) -> list:
    """(c): each socket's ``conversation`` row, read back through
    ``GET /conversation/{id}``, holds its digest, its token count and the
    key of its socket; redis holds its text."""
    out = []
    for i, s in enumerate(socks):
        done = s["done"] or {}
        got = rows.get(done.get("id"))
        if got is None or got[0] != 200:
            out.append(f"row_{i} missing")
            continue
        row = got[2]["data"]
        if row["digest"] != done.get("digest") \
                or row["n_generated"] != len(_ws_tokens(s)) \
                or not row["socket"]:
            out.append(f"row_{i}")
        if texts.get(done.get("id")) != decode(_ws_tokens(s)):
            out.append(f"text_{i}")
    return out


def _ws_leave_faults(left, samples: list) -> list:
    """(d): the request of a socket closed after 3 frames is cancelled
    with fewer than ``WS_NEW`` tokens decoded, its slot free within 2 s."""
    return _freed_faults(samples, 2.0) + (
        [] if left is not None and left.cancelled
        and len(left.generated) < WS_NEW else ["not cancelled"])


def _ws_error_faults(bad: dict | None, after: dict, plain: tuple) -> list:
    """(e): a malformed frame gets ``{"error": ...}`` and the socket's
    next frame is served; a plain ``GET /ws/chat`` answers 426."""
    out = []
    if not isinstance(bad, dict) or "error" not in bad:
        out.append("no error frame")
    if (after.get("done") or {}).get("done") != len(after["frames"]) \
            or not after["frames"]:
        out.append("next frame not served")
    if plain[0] != 426:
        out.append(f"plain GET {plain[0]}")
    return out


def _ws_stop_faults(run: dict) -> list:
    """(f): ``App.stop`` closed every socket (close code 1001, the
    manager empty) and stopped the engine."""
    out = []
    if run["close_codes"] != [1001] * len(run["close_codes"]) \
            or not run["close_codes"]:
        out.append(f"close codes {run['close_codes']}")
    if run["sockets_left"] != 0:
        out.append(f"{run['sockets_left']} sockets left")
    if run["engine_running"] or not run["app_stopped"]:
        out.append("not stopped")
    return out


def _ws_timing(runs: list) -> dict:
    """Client TTFT over the socket (the first token frame, s after the
    send) p50 / p99, the gaps between a socket's token frames p50 / p99
    (ms), and decode tokens/s: tokens after each socket's first over the
    span from the earliest first frame to the latest last one."""
    ttft, gaps, firsts, lasts, after_first = [], [], [], [], 0
    for run in runs:
        times = [t for t, _ in run["frames"]]
        if not times:
            continue
        ttft.append(times[0])
        gaps += [(b - a) * 1000.0 for a, b in zip(times, times[1:])]
        firsts.append(times[0] + run["sent_at"])
        lasts.append(times[-1] + run["sent_at"])
        after_first += len(times) - 1
    span = max(lasts) - min(firsts) if firsts else 0.0
    return {"ttft_s": _pcts(ttft), "frame_gap_ms": _pcts(gaps),
            "decode_tokens_per_s": after_first / span if span > 0 else None,
            "sockets": len(ttft)}


def phase_serve_ws(dev, smi_line: str) -> dict:
    """The framework's batteries on the card: ``serving/model_serving.
    build_app`` with ``MODEL_PRESET=llama3_1b`` (full width and depth,
    random bf16 weights from seed 0, ``serve_config``: 8 slots, prefix
    cache on), ``DB_DIALECT=sqlite`` on a file in a temporary directory
    and ``REDIS_HOST=localhost`` (the embedded store), on an event loop in
    a thread. ``app.migrate`` applies two versions (the ``conversation``
    table; a redis key), ``app.add_rest_handlers(Conversation)`` serves
    the table, and ``/ws/chat`` is a chat handler written here, as a user
    would: ``async``, it binds ``{"prompt", "max_tokens"}``, submits
    through the engine behind ``/chat`` (greedy), sends each token as a
    frame with ``ctx.write_message_to_socket``, writes one
    ``conversation`` row through ``ctx.sql``, caches the text in
    ``ctx.redis`` and answers ``{"done", "digest", "id"}``. The client is
    the port's ``websocket.connect``. Checks, each also shown a planted
    fault it must reject:

    (a) versions 1-2 applied once, a second ``migrate`` applies none, a
        version 3 that raises leaves no table and no ledger row; health
        200 with ``sql``, ``redis`` and the engine ``llama`` UP; planted:
        the state version 3 saw inside its transaction.
    (b) 16 sockets at once on the 8 slots (``_ws_prompts``: 21-1501
        tokens, 64 new), gated as ``serve_app``'s waves, then the same 16
        as unary ``/chat``, gated: every socket's frame tokens equal its
        ``/chat`` tokens, every request digest equal; planted: a frame
        dropped.
    (c) every socket's row through ``GET /conversation/{id}`` with its
        digest and token count, its text in redis; planted: a row
        written through ``POST /conversation`` with a changed digest.
    (d) a socket closed after 3 token frames frees its slot within 2 s
        (the slot's samples), fewer than 64 tokens decoded; planted: the
        socket left open.
    (e) a malformed frame answers ``{"error": ...}`` and the same
        socket's next frame is served; ``GET /ws/chat`` answers 426;
        planted: the error frame replaced by a close.
    (f) the launch counters, zeroed before (b) and read after it: flash,
        paged decode, paged chunk and ``rope_kv_write`` rise; then, with
        3 sockets open, ``App.stop`` closes them (1001), empties the
        manager and stops the engine; planted: the counters read before
        the wave.

    Also, ungated (unique prompts, engine running), the 16 prompts over
    16 sockets at once and as 16 ``/chat`` streams at once, socket /
    stream / stream / socket: client TTFT p50 / p99 beside the engine's,
    the gaps between token frames (SSE reads) p50 / p99, decode
    tokens/s."""
    import asyncio
    import copy
    import shutil
    import tempfile
    import torch
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.handler import ThreadPump
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write
    from gofr_tpu_torch.serving import model_serving
    from gofr_tpu_torch.serving.engine import SamplingParams
    from gofr_tpu_torch.serving.handlers import POLL_S
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "rope_kv_write": rope_kv_write}
    checks: dict = {}
    out: dict = {"phase": "serve_ws", "card": smi_line}
    greedy = {"max_tokens": WS_NEW, "temperature": 0}
    tmp = tempfile.mkdtemp(prefix="serve_ws_")
    app = model_serving.build_app(DictConfig({
        "MODEL_PRESET": "llama3_1b", "HTTP_HOST": "127.0.0.1",
        "HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "serve-ws",
        "DB_DIALECT": "sqlite", "DB_NAME": str(Path(tmp) / "ws.db"),
        "REDIS_HOST": "localhost"}), device=dev)
    engine = app.container.get_model(model_serving.MODEL_NAME)
    tok = ByteTokenizer()
    made: list = []
    inner_submit = engine.submit

    def submit(*args, **kwargs):
        made.append(inner_submit(*args, **kwargs))
        return made[-1]

    engine.submit = submit

    # (a) the migrations, before the app starts
    _WS_INSIDE.clear()
    first = app.migrate(_ws_migrations())
    again = app.migrate(_ws_migrations())
    try:
        app.migrate(_ws_migrations(planted=True))
        v3_raised = False
    except RuntimeError:
        v3_raised = True
    sql, redis = app.container.sql, app.container.redis
    migrated = {"first": first, "again": again, "v3_raised": v3_raised,
                "after": _sql_state(sql),
                "redis_ledger": sorted(redis.keys("gofr_migrations:*")),
                "schema_key": redis.get("ws_chat:schema")}
    inside = {**migrated, "after": dict(_WS_INSIDE)}
    app.add_rest_handlers(Conversation)

    @app.websocket("/ws/chat")
    async def ws_chat(ctx):
        body = ctx.bind()
        prompt, max_tokens = body["prompt"], int(body["max_tokens"])
        loop = asyncio.get_running_loop()

        def submit_it():
            prompt_tokens = tok.encode(prompt)
            return engine.submit(prompt_tokens, SamplingParams(
                temperature=0.0, max_new_tokens=max_tokens),
                tenant=ctx.tenant), len(prompt_tokens)

        req, n_prompt = await loop.run_in_executor(app.executor, submit_it)
        if req.error:
            raise RuntimeError(f"refused: {req.error}")
        pump = ThreadPump(engine.stream_request(req, timeout_s=POLL_S),
                          ctx.client_gone, ctx.mark_gone, app.executor, loop)
        tokens: list = []
        try:
            async for token in pump:
                if token is None:
                    continue
                tokens.append(token)
                await ctx.write_message_to_socket(
                    {"token": token, "text": tok.decode([token])})
        finally:
            await pump.aclose()
        if req.error:
            raise RuntimeError(f"generation failed: {req.error}")

        def store() -> int:
            cur = ctx.sql.exec(
                "INSERT INTO conversation (socket, prompt_tokens, "
                "n_generated, digest) VALUES (?, ?, ?, ?)",
                ctx.header("sec-websocket-key"), n_prompt, len(tokens),
                req.digest)
            ctx.redis.set(f"ws_chat:{cur.lastrowid}", tok.decode(tokens))
            return cur.lastrowid

        row_id = await loop.run_in_executor(app.executor, store)
        return {"done": len(tokens), "digest": req.digest, "id": row_id}

    loop = asyncio.new_event_loop()
    booted, boot_error = threading.Event(), []

    def run_loop():
        asyncio.set_event_loop(loop)

        async def main():
            try:
                await app.start()
            except BaseException as exc:  # noqa: BLE001 — reported below
                boot_error.append(exc)
                raise
            finally:
                booted.set()
            await app._stop_event.wait()

        try:
            loop.run_until_complete(main())
        except BaseException:  # noqa: BLE001 — boot_error holds it
            pass

    loop_thread = threading.Thread(target=run_loop, daemon=True)
    loop_thread.start()
    if not booted.wait(600) or boot_error:
        raise AssertionError(f"serve_ws: the app did not boot {boot_error}")
    aport = app.port

    def wait_made(n: int) -> None:
        deadline = time.time() + 60
        while len(made) < n and time.time() < deadline:
            time.sleep(0.001)

    #: requests in flight when a gated socket wave's engine starts
    queued: list = []

    def gated_sockets(bodies: list) -> tuple:
        """Each body over a socket of its own, queued in order on the
        stopped engine, then the engine started: (runs, requests)."""
        engine.stop()
        engine.waiting.reopen()
        base = len(made)

        async def wave():
            tasks = []
            for i, body in enumerate(bodies):
                sent = asyncio.Event()
                tasks.append(asyncio.ensure_future(
                    _ws_ask(aport, body, sent=sent)))
                await sent.wait()
                await asyncio.to_thread(wait_made, base + i + 1)
            queued.append(sum(r.finished_at is None for r in made[base:]))
            await asyncio.to_thread(engine.start)
            return await asyncio.gather(*tasks)

        runs = asyncio.run(asyncio.wait_for(wave(), 600))
        return list(runs), made[base:]

    def gated_unary(bodies: list) -> tuple:
        engine.stop()
        engine.waiting.reopen()
        base = len(made)
        got: list = [None] * len(bodies)

        def call(i, body):
            got[i] = _http_json(aport, "POST", "/chat", body)

        workers = []
        for i, body in enumerate(bodies):
            workers.append(threading.Thread(target=call, args=(i, body)))
            workers[-1].start()
            wait_made(base + i + 1)
        engine.start()
        for w in workers:
            w.join(timeout=600)
        return got, made[base:]

    try:
        # (a) health, before any traffic
        health = _http_json(aport, "GET", "/.well-known/health")
        checks["a_migrations"] = (
            _migrate_faults(migrated) + _ws_health_faults(health),
            _migrate_faults(inside))
        out["a"] = {"applied": first, "again": again,
                    "v3_rolled_back": not _migrate_faults(migrated),
                    "inside_v3": _WS_INSIDE,
                    "health": {k: v.get("status") for k, v in
                               (health[2]["data"].get("checks") or {})
                               .items()}}
        # (b) the wave over sockets, then as unary /chat, both gated
        for fn in counters.values():
            fn.launches = 0
        prompts = _ws_prompts()
        bodies = [{"prompt": p, **greedy} for p in prompts]
        socks, ws_reqs = gated_sockets(bodies)
        launches = {name: int(fn.launches) for name, fn in counters.items()}
        unary, u_reqs = gated_unary(bodies)
        dropped = copy.deepcopy(socks)
        del dropped[2]["frames"][5]
        checks["b_socket_wave"] = (
            _ws_wave_faults(socks, ws_reqs, unary, u_reqs),
            _ws_wave_faults(dropped, ws_reqs, unary, u_reqs))
        out["b"] = {"sockets": len(socks),
                    "prompt_tokens": [len(r.prompt_tokens) for r in ws_reqs],
                    "in_flight_at_start": queued[-1],
                    "slots": engine.config.max_batch,
                    "tokens_0": _ws_tokens(socks[0])[:8]}
        # (c) the stores: each socket's row and text
        rows = {(s["done"] or {}).get("id"): _http_json(
            aport, "GET", f"/conversation/{(s['done'] or {}).get('id')}")
            for s in socks}
        texts = {i: redis.get(f"ws_chat:{i}") for i in rows}
        bent = dict(socks[0]["done"] or {})
        posted = _http_json(aport, "POST", "/conversation", {
            "id": 100000, "socket": "planted",
            "prompt_tokens": len(ws_reqs[0].prompt_tokens),
            "n_generated": bent.get("done"),
            "digest": "0" * len(bent.get("digest") or "x")})
        planted_socks = [{**socks[0], "done": {**bent, "id": 100000}}]
        planted_rows = {100000: _http_json(aport, "GET",
                                           "/conversation/100000")}
        planted_texts = {100000: texts.get(bent.get("id"))}
        checks["c_stores"] = (
            _ws_store_faults(socks, rows, texts, tok.decode)
            + ([] if posted[0] == 201 else [f"planted POST {posted[0]}"]),
            _ws_store_faults(planted_socks, planted_rows, planted_texts,
                             tok.decode))
        out["c"] = {"rows": len(rows), "row_0": rows.get(bent.get("id"),
                                                         (None, {}, {}))[2]}
        # (d) an early close, and the planted socket left open
        since = len(made)
        closer = asyncio.run(_ws_ask(aport, {"prompt": prompts[2],
                                             "max_tokens": 1024},
                                     close_after=3))
        samples = _watch_slots(engine, 5.0, closer["closed_at"])
        left = made[since] if len(made) > since else None
        since = len(made)

        async def held():
            run = await _ws_ask(aport, {"prompt": prompts[3],
                                        "max_tokens": 1024},
                                close_after=3, hold=True)
            at = time.perf_counter()
            kept = await asyncio.to_thread(_watch_slots, engine, 2.5, at)
            await run["conn"].close()
            return kept
        kept_samples = asyncio.run(held())
        kept = made[since] if len(made) > since else None
        _watch_slots(engine, 30.0, time.perf_counter())
        checks["d_early_close"] = (_ws_leave_faults(left, samples),
                                   _ws_leave_faults(kept, kept_samples))
        out["d"] = {"left_tokens": None if left is None
                    else len(left.generated),
                    "left_freed_s": next((t for t, b in samples if b == 0),
                                         None),
                    "kept_tokens_at_2_5s": None if kept is None
                    else len(kept.generated)}

        # (e) a handler error on a socket that serves on
        async def errors():
            from gofr_tpu_torch.websocket import connect
            conn = await connect(f"ws://127.0.0.1:{aport}/ws/chat")
            await conn.send("not json {")
            message = await conn.recv()
            bad = json.loads(message.text()) if message is not None else None
            await conn.send({"prompt": prompts[0], "max_tokens": 4})
            after = {"frames": [], "done": None}
            while True:
                message = await conn.recv()
                if message is None:
                    break
                frame = json.loads(message.text())
                if "token" not in frame:
                    after["done"] = frame
                    break
                after["frames"].append((0.0, frame))
            await conn.close()
            return bad, after
        bad, after = asyncio.run(asyncio.wait_for(errors(), 120))
        plain = _http_json(aport, "GET", "/ws/chat")
        checks["e_errors"] = (_ws_error_faults(bad, after, plain),
                              _ws_error_faults(None, after, plain))
        out["e"] = {"error_frame": bad, "next_tokens": len(after["frames"]),
                    "plain_get": plain[0]}
        # ungated timing, unique prompts: sockets / streams / streams /
        # sockets
        timing: dict = {"ws": [], "chat": []}
        for i, side in enumerate(("ws", "chat", "chat", "ws")):
            asks = [{"prompt": p, **greedy} for p in _ws_prompts(f"t{i} ")]
            base = len(made)
            if side == "ws":
                async def at_once(asks=asks):
                    return await asyncio.gather(*(_ws_ask(aport, b)
                                                  for b in asks))
                run = _ws_timing(asyncio.run(asyncio.wait_for(at_once(),
                                                              600)))
            else:
                got: list = [None] * len(asks)

                def call(j, body, got=got):
                    got[j] = _sse_call(aport, "/chat",
                                       {**body, "stream": True})
                workers = [threading.Thread(target=call, args=(j, b))
                           for j, b in enumerate(asks)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=600)
                run = _sse_timing(got)
            run["engine_ttft_s"] = _pcts([r.ttft_ms / 1000.0
                                          for r in made[base:]
                                          if r.ttft_ms is not None])
            timing[side].append(run)
        out["timing"] = {**timing, "card": smi_line,
                         "definition": "16 sockets (16 /chat streams) at "
                         "once on 8 slots, 64 tokens each, prompts "
                         "21-1501 tokens; TTFT from the send to the first "
                         "token frame (event)"}
        # (f) the kernels of the wave, then the stop with sockets open
        checks["f_launches"] = (_launch_faults(launches),
                                _launch_faults(dict.fromkeys(launches, 0)))
        out["launches"] = launches

        async def stop_with_open():
            from gofr_tpu_torch.websocket import connect
            conns = [await connect(f"ws://127.0.0.1:{aport}/ws/chat")
                     for _ in range(3)]
            for _ in range(500):
                if len(app.container.ws_manager) >= 3:
                    break
                await asyncio.sleep(0.01)
            await asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(app.stop(), loop))
            return [(await c.recv(), c.close_code)[1] for c in conns]
        codes = asyncio.run(asyncio.wait_for(stop_with_open(), 120))
        loop_thread.join(timeout=30)
        stopped = {"close_codes": codes,
                   "sockets_left": len(app.container.ws_manager),
                   "engine_running": engine._running,
                   "app_stopped": app._stop_event.is_set()}
        checks["f_stop"] = (_ws_stop_faults(stopped), _ws_stop_faults(
            {**stopped, "close_codes": [None] * len(codes)}))
        out["f"] = stopped
    finally:
        engine.submit = inner_submit
        if loop.is_running():
            asyncio.run_coroutine_threadsafe(app.stop(), loop).result(60)
        loop_thread.join(timeout=30)
        if not loop.is_running():
            loop.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del app, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_ws: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out["launches"]


WIRE_TOPICS = ("jobs-0", "jobs-1", "jobs-2", "jobs-3")
WIRE_GROUP = "jobs"
WIRE_USER, WIRE_PW, WIRE_DB = "gofr", "wire-secret", "gofr"
#: the remote-level poll interval (s): ``logging/remote.py``'s floor
WIRE_POLL_S = 1.0


class _WireEndpoint:
    """``serve_wire``'s collector and remote-level endpoint: a stdlib HTTP
    server on a thread. Each ``POST`` (an OTLP/HTTP JSON batch) is kept
    decoded; ``GET`` answers ``{"level": self.level}``."""

    def __init__(self, level: str = "INFO") -> None:
        import http.server
        self.level = level
        self.batches: list = []
        self.gets = 0
        endpoint = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                size = int(self.headers.get("Content-Length", 0))
                endpoint.batches.append(json.loads(self.rfile.read(size)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                endpoint.gets += 1
                body = json.dumps({"level": endpoint.level}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="wire-endpoint")
        self._thread.start()

    def spans(self) -> list:
        return [span for batch in list(self.batches)
                for rs in batch.get("resourceSpans", [])
                for ss in rs.get("scopeSpans", [])
                for span in ss.get("spans", [])]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class _LoopThread:
    """An event loop on a daemon thread: the Mini brokers and the
    phase's own broker clients live there."""

    def __init__(self) -> None:
        import asyncio
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        daemon=True, name="wire-brokers")
        self._thread.start()

    def run(self, coro, timeout: float = 60.0):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def spawn(self, coro):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(10)
        self.loop.close()


def _open_connections(port: int) -> int:
    """ESTABLISHED TCP connections with ``port`` at either end, from the
    kernel's table (both ends of a loopback connection count)."""
    count = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            rows = Path(table).read_text().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            fields = row.split()
            if fields[3] != "01":
                continue
            if port in (int(fields[1].rsplit(":", 1)[1], 16),
                        int(fields[2].rsplit(":", 1)[1], 16)):
                count += 1
    return count


def _boot_app(app, name: str) -> tuple:
    """``app.start()`` on a new event loop in a thread: (loop, thread),
    once it has booted."""
    import asyncio
    loop = asyncio.new_event_loop()
    booted, boot_error = threading.Event(), []

    def run_loop():
        asyncio.set_event_loop(loop)

        async def main():
            try:
                await app.start()
            except BaseException as exc:  # noqa: BLE001 — reported below
                boot_error.append(exc)
                raise
            finally:
                booted.set()
            await app._stop_event.wait()

        try:
            loop.run_until_complete(main())
        except BaseException:  # noqa: BLE001 — boot_error holds it
            pass

    thread = threading.Thread(target=run_loop, daemon=True)
    thread.start()
    if not booted.wait(600) or boot_error:
        raise AssertionError(f"{name}: the app did not boot {boot_error}")
    return loop, thread


def _stop_app(app, loop, thread) -> None:
    import asyncio
    if loop.is_running():
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(60)
    thread.join(timeout=30)
    if not loop.is_running():
        loop.close()


def _wire_migrations() -> dict:
    """Version 1: the ``conversation`` table, one row per answered job."""
    from gofr_tpu_torch.migrations import Migrate

    def v1(ds):
        ds.sql.exec("CREATE TABLE conversation (job TEXT PRIMARY KEY, "
                    "topic TEXT, prompt_tokens INTEGER, n_generated "
                    "INTEGER, digest TEXT)")
    return {1: Migrate(up=v1)}


def _job_handler(engine, tok, app_loop: dict, op_ms: dict):
    """The subscriber's handler, as a user writes it: plain (it runs on
    the app's handler pool), it binds ``{"id", "prompt", "max_tokens"}``,
    submits greedy to the engine behind ``/chat`` and waits, writes one
    ``conversation`` row through ``ctx.sql``, sets the text in
    ``ctx.redis`` and publishes ``{"id", "tokens", "digest"}`` to
    ``answers`` on the app's loop (``app_loop["loop"]``). Its own span
    (``job <id>``) is the parent of the SQL client's span and of a
    ``redis SET`` span around the RESP call (neither JAX's subscriber nor
    its RESP client makes a span). ``op_ms`` collects each SQL and redis
    call's wall time."""
    import asyncio
    from gofr_tpu_torch.serving.engine import SamplingParams

    def job(ctx):
        body = ctx.bind()
        with ctx.trace(f"job {body['id']}"):
            prompt_tokens = tok.encode(body["prompt"])
            req = engine.submit(prompt_tokens, SamplingParams(
                temperature=0.0, max_new_tokens=int(body["max_tokens"])))
            if not req.done.wait(600) or req.error:
                raise RuntimeError(f"job {body['id']}: "
                                   f"{req.error or 'timed out'}")
            tokens = list(req.generated)
            sql = ctx.sql
            t0 = time.perf_counter()
            sql.exec("INSERT INTO conversation (job, topic, prompt_tokens, "
                     "n_generated, digest) VALUES "
                     f"({', '.join(sql.ph(i) for i in range(1, 6))})",
                     body["id"], ctx.request.topic, len(prompt_tokens),
                     len(tokens), req.digest)
            t1 = time.perf_counter()
            with ctx.trace("redis SET"):
                ctx.redis.set(f"job:{body['id']}", tok.decode(tokens))
            t2 = time.perf_counter()
            op_ms["sql"].append((t1 - t0) * 1000.0)
            op_ms["redis"].append((t2 - t1) * 1000.0)
            asyncio.run_coroutine_threadsafe(ctx.publish("answers", {
                "id": body["id"], "tokens": tokens,
                "digest": req.digest}), app_loop["loop"]).result(60)
    return job


class _Answers:
    """The phase's side of a broker: a producer client and a consumer
    client of the backend (the port's), on the broker loop. The consumer
    reads ``answers`` into ``got`` (id -> (receive time, answer))."""

    def __init__(self, brokers: _LoopThread, make_client, group: str):
        self.brokers = brokers
        self.producer = make_client("smoke-producer")
        self.consumer = make_client("smoke-consumer")
        self.got: dict = {}
        self.sent: dict = {}
        for client in (self.producer, self.consumer):
            if hasattr(client, "connect"):    # the REST client has none
                brokers.run(client.connect())

        async def consume():
            while True:
                msg = await self.consumer.subscribe("answers", group)
                answer = json.loads(msg.value)
                self.got[answer["id"]] = (time.perf_counter(), answer)
                msg.commit()
        self._task = brokers.spawn(consume())

    def publish(self, topic: str, jobs: list) -> None:
        """``jobs`` ({"id", "prompt", "max_tokens"} each) to ``topic``,
        each stamped with its publish time."""
        for job in jobs:
            self.sent[job["id"]] = time.perf_counter()
            self.brokers.run(self.producer.publish(topic, job))

    def wait(self, ids: list, timeout_s: float = 600.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if all(i in self.got for i in ids):
                return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._task.cancel()
        for client in (self.producer, self.consumer):
            try:
                self.brokers.run(client.close(), timeout=10)
            except Exception:  # noqa: BLE001 — best effort at teardown
                pass


def _near_tie_judge(params: dict, cfg, float32=None) -> "callable":
    """A judge of greedy divergences: ``judge(prompt, common, a, b)``
    takes the tokens two runs of one prompt share (``common``) and the
    tokens they then chose (``a``, ``b``), and runs the model's plain
    path on ``prompt + common`` in float32 and in bf16. The divergence
    is a near tie when ``a`` and ``b`` both lie within twice the bf16
    forward's error (on its top eight logits) of the float32 forward's
    top logit: a bf16 run (another prefill pass or kernel, another
    rounding) off by up to that much picks only such a token, so two
    runs can part between them. The float32 weights are made at the
    first call (``float32()`` makes them where given: a quantized tree's
    dequantized weights)."""
    import torch
    from gofr_tpu_torch.models.llama import llama_prefill_last
    held: dict = {}

    def judge(prompt: list, common: list, a: int, b: int) -> dict:
        t0 = time.perf_counter()
        try:
            return verdict(prompt, common, a, b)
        finally:
            held["seconds"] = held.get("seconds", 0.0) \
                + time.perf_counter() - t0

    def verdict(prompt: list, common: list, a: int, b: int) -> dict:
        if "p32" not in held:
            held["p32"] = float32() if float32 is not None \
                else _tree_float(params)
            held["c32"] = cfg.scaled(dtype=torch.float32)
        dev = params["final_norm"].device
        seq = torch.tensor([list(prompt) + list(common)], device=dev)
        lens = torch.tensor([seq.shape[1]], dtype=torch.int32, device=dev)
        with torch.no_grad():
            l16 = llama_prefill_last(params, seq, cfg, kv_lengths=lens,
                                     implementation="plain")[0][0]
            l32 = llama_prefill_last(held["p32"], seq, held["c32"],
                                     kv_lengths=lens,
                                     implementation="plain")[0][0]
        top = l32.topk(8)
        err = float((l16[top.indices] - top.values).abs().max())
        below = [float(top.values[0] - l32[t]) for t in (a, b)]
        return {"below_top": below, "bf16_err": err,
                "top2": [int(i) for i in top.indices[:2]],
                "near_tie": max(below) <= 2 * err}
    judge.release = held.clear
    judge.seconds = lambda: held.get("seconds", 0.0)
    return judge


def _tie_or_fault(label: str, tokens: list, ref: list, prompt: list,
                  judge, ties: dict) -> list:
    """``tokens`` equal ``ref``, or first differ at a near tie
    (``judge``; recorded in ``ties``); else a fault."""
    if tokens == ref:
        return []
    if len(tokens) != len(ref):
        return [f"{label} {len(tokens)} tokens"]
    at = next(i for i, (x, y) in enumerate(zip(tokens, ref)) if x != y)
    verdict = judge(prompt, ref[:at], tokens[at], ref[at])
    ties[label] = {"at": at, **verdict}
    return [] if verdict["near_tie"] else [f"{label} tokens at {at}"]


def _wire_answer_faults(answers: dict, ids: list, unary: list,
                        u_reqs: list, judge, ties: dict) -> list:
    """(b): each job's answer carries ``WS_NEW`` tokens equal to its
    prompt's unary ``/chat`` tokens and that request's digest, or first
    differs from them at a near tie (``_near_tie_judge``)."""
    out = []
    for i, (job_id, u) in enumerate(zip(ids, unary)):
        got = answers.get(job_id)
        if got is None:
            out.append(f"{job_id} missing")
            continue
        if u[0] != 201 or len(u[2]["data"]["tokens"]) != WS_NEW \
                or i >= len(u_reqs) or u_reqs[i].digest is None:
            out.append(f"unary_{i}")
            continue
        ref = u[2]["data"]["tokens"]
        out += _tie_or_fault(job_id, got["tokens"], ref,
                             u_reqs[i].prompt_tokens, judge, ties)
        if got["tokens"] == ref and got["digest"] != u_reqs[i].digest:
            out.append(f"{job_id} digest")
    return out


def _wire_divergence(answers: dict, ids: list, u_reqs: list,
                     job_reqs: dict) -> dict:
    """For each job whose tokens differ from its prompt's unary ``/chat``
    answer: the first differing position and both requests' prefill
    passes (bucket, rows in the pass, or the walk's offset)."""
    out = {}
    for job_id, ref in zip(ids, u_reqs):
        tokens = answers.get(job_id, {}).get("tokens") or []
        if tokens == ref.generated:
            continue
        at = next((i for i, (a, b) in enumerate(zip(tokens, ref.generated))
                   if a != b), min(len(tokens), len(ref.generated)))
        job = job_reqs.get(tuple(ref.prompt_tokens))
        out[job_id] = {
            "at": at,
            "job_prefill": [a for n, _, _, a in (job.events if job else [])
                            if n == "prefill"],
            "ref_prefill": [a for n, _, _, a in ref.events
                            if n == "prefill"]}
    return out


def _wire_store_faults(answers: dict, rows: dict, texts: dict,
                       decode) -> list:
    """(c), (g): each job's row, read back over the SQL wire, holds its
    answer's digest and token count; its text, read back over RESP, is
    the decoded answer."""
    out = []
    for job_id, answer in answers.items():
        row = rows.get(job_id)
        if row is None:
            out.append(f"{job_id} row missing")
            continue
        if row["digest"] != answer["digest"] or \
                row["n_generated"] != len(answer["tokens"]):
            out.append(f"{job_id} row")
        if texts.get(job_id) != decode(answer["tokens"]):
            out.append(f"{job_id} text")
    return out


def _wire_span_faults(spans: list, ids: list, chat_streams: int) -> list:
    """(e): each job's span (``job <id>``) reached the collector with the
    SQL client's ``sql INSERT`` span and the ``redis SET`` span as its
    children, and the ``/chat`` streams' request spans did."""
    out = []
    by_parent: dict = {}
    for span in spans:
        by_parent.setdefault(span.get("parentSpanId"), []).append(
            span["name"])
    jobs = {span["name"]: span for span in spans
            if span["name"].startswith("job ")}
    for job_id in ids:
        span = jobs.get(f"job {job_id}")
        if span is None:
            out.append(f"{job_id} span missing")
            continue
        children = by_parent.get(span["spanId"], [])
        if "sql INSERT" not in children or "redis SET" not in children:
            out.append(f"{job_id} children {children}")
    chats = sum(span["name"] == "POST /chat" for span in spans)
    if chats < chat_streams:
        out.append(f"{chats} /chat spans")
    return out


def _wire_level_faults(level: dict) -> list:
    """(e): the app logger at DEBUG within two poll intervals of the
    endpoint's switch."""
    if level["after"] != "DEBUG" or level["switched_s"] is None or \
            level["switched_s"] > 2 * WIRE_POLL_S:
        return [f"level {level}"]
    return []


def _wire_offset_faults(offsets: dict, per_topic: int) -> list:
    """(d): the group's committed offset on each job topic."""
    return [f"{t} at {offsets.get(t)}" for t in WIRE_TOPICS
            if offsets.get(t) != per_topic]


def _wire_health_faults(health: tuple, sql_details: dict,
                        want: dict) -> list:
    """(a): health 200 UP with ``sql``, ``redis``, ``pubsub`` and the
    engine ``llama`` UP, ``sql``'s details those of the postgres wire
    client on the Mini server (``want``)."""
    data = health[2].get("data") or {}
    checks = data.get("checks") or {}
    out = [] if health[0] == 200 and data.get("status") == "UP" \
        else [f"health {health[0]} {data.get('status')}"]
    for name in ("sql", "redis", "pubsub"):
        if (checks.get(name) or {}).get("status") != "UP":
            out.append(f"{name} not UP")
    engines = ((checks.get("tpu") or {}).get("details") or {}).get(
        "engines") or {}
    if (engines.get("llama") or {}).get("status") != "UP":
        out.append("engine not UP")
    if sql_details != want:
        out.append(f"sql details {sql_details}")
    return out


def _wire_stop_faults(stopped: dict) -> list:
    """After ``App.stop`` no connection is open to a Mini server
    (``stopped["open"]``: serve_wire's (f), serve_stores' (e)), and the
    engine is stopped."""
    out = [f"{name}: {n} open" for name, n in stopped["open"].items() if n]
    if stopped["engine_running"]:
        out.append("engine running")
    return out


def _hist_p50_ms(metrics, name: str) -> float | None:
    """The median of a histogram's samples (ms), interpolated within its
    bucket as Prometheus' ``histogram_quantile`` does (the counts are
    cumulative)."""
    hist = metrics.get(name)
    if hist is None:
        return None
    snap = hist.snapshot()
    cum = [0] * len(snap["buckets"])
    total = 0
    for series in snap["series"]:
        total += series["count"]
        for i, c in enumerate(series["counts"]):
            cum[i] += c
    if not total:
        return None
    rank, prev, lower = total / 2.0, 0, 0.0
    for bound, c in zip(snap["buckets"], cum):
        if c >= rank:
            return (lower + (bound - lower) * (rank - prev)
                    / max(c - prev, 1)) * 1000.0
        prev, lower = c, bound
    return snap["buckets"][-1] * 1000.0


def _engine_rate(reqs: list) -> float | None:
    """Decode tokens/s over ``reqs``: tokens after each request's first,
    over the span from the earliest first token to the latest finish."""
    done = [r for r in reqs if r.first_token_at and r.finished_at]
    if not done:
        return None
    span = max(r.finished_at for r in done) - min(r.first_token_at
                                                  for r in done)
    return sum(len(r.generated) - 1 for r in done) / span if span > 0 \
        else None


def _g_answer_faults(name: str, answers: dict, want: dict, encode,
                     judge, ties: dict) -> list:
    """(g): each prompt's answer (tokens, digest) equals ``want``'s, the
    same prompt's answer in (b), or first differs from it at a near
    tie."""
    out = []
    for prompt, ref in want.items():
        got = answers.get(prompt)
        label = f"{name}: {prompt[:12]!r}"
        if got is None:
            out.append(f"{label} missing")
            continue
        out += _tie_or_fault(label, got["tokens"], ref["tokens"],
                             encode(prompt), judge, ties)
        if got["tokens"] == ref["tokens"] and \
                got["digest"] != ref["digest"]:
            out.append(f"{label} digest")
    return out


def _wire_backend(name: str, brokers: _LoopThread, servers: dict) -> tuple:
    """(g): the config of one other backend, the Mini servers it needs
    (started; the broker's on the broker loop) and a factory of the
    phase's own client of its broker."""
    from gofr_tpu_torch.datasource.mysql_wire import MiniMySQLServer
    from gofr_tpu_torch.datasource.oracle_wire import MiniOracleServer
    from gofr_tpu_torch.datasource.redis_wire import MiniRedisServer
    from gofr_tpu_torch.pubsub import (eventhub, google, jetstream, kafka,
                                       mqtt, nats)
    host = "127.0.0.1"
    # a redis of its own: the migration ledger is kept in every store, and
    # (b)'s redis already records version 1
    cache = MiniRedisServer()
    cache.start()
    started: list = [cache]
    env = {"DB_DIALECT": "postgres", "DB_HOST": host,
           "DB_PORT": str(servers["postgres"].port), "DB_USER": WIRE_USER,
           "DB_PASSWORD": WIRE_PW, "DB_NAME": WIRE_DB, "REDIS_HOST": host,
           "REDIS_PORT": str(cache.port), "REDIS_MODE": "network"}
    if name in ("mysql", "oracle"):
        sql = MiniMySQLServer(user=WIRE_USER, password=WIRE_PW) \
            if name == "mysql" else MiniOracleServer(
                users={WIRE_USER: WIRE_PW})
        sql.start()
        started.append(sql)
        env.update({"DB_DIALECT": name, "DB_PORT": str(sql.port)})
        if name == "oracle":
            del env["DB_NAME"]          # the service name: FREEPDB1
    broker_cls = {"mysql": kafka.MiniKafkaBroker,
                  "oracle": kafka.MiniKafkaBroker,
                  "EVENTHUB": kafka.MiniKafkaBroker,
                  "NATS": nats.MiniNATSServer,
                  "JETSTREAM": jetstream.MiniJetStreamServer,
                  "MQTT": mqtt.MiniMQTTBroker,
                  "GOOGLE": google.MiniPubSubEmulator}[name]
    broker = broker_cls()
    brokers.run(broker.start())
    addr = f"{host}:{broker.port}"
    backend = {"mysql": "KAFKA", "oracle": "KAFKA"}.get(name, name)
    env.update({"PUBSUB_BACKEND": backend, "PUBSUB_BROKER": addr,
                "KAFKA_CONSUMER_GROUP": WIRE_GROUP, "EVENTHUB_NAME": "hub",
                "GOOGLE_PROJECT_ID": "gofr", "MQTT_HOST": host,
                "MQTT_PORT": str(broker.port)})
    clients = {
        "KAFKA": lambda cid: kafka.KafkaClient(addr, group_id=cid,
                                               client_id=cid),
        "EVENTHUB": lambda cid: eventhub.EventHubClient(
            addr, eventhub="hub", consumer_group=cid),
        "NATS": lambda cid: nats.NATSClient(host, broker.port, name=cid),
        "JETSTREAM": lambda cid: jetstream.JetStreamClient(
            host, broker.port, name=cid),
        "MQTT": lambda cid: mqtt.MQTTClient(host=host, port=broker.port,
                                            client_id=cid, qos=1),
        "GOOGLE": lambda cid: google.GooglePubSubClient(addr, "gofr")}
    return env, broker, started, clients[backend]


def _wire_subscribed(broker, topic: str) -> bool:
    """Whether ``broker`` (a Mini server) holds a subscription to
    ``topic``: core NATS, MQTT and the emulator drop what is published
    before one exists; the Kafka logs and JetStream streams keep it."""
    if type(broker).__name__ == "MiniJetStreamServer":
        return True                                # streams keep it
    subs = getattr(broker, "_subs", None)
    if isinstance(subs, list):                     # core NATS
        return any(pattern == topic for _, _, pattern, _ in subs)
    sessions = getattr(broker, "_sessions", None)
    if sessions is not None:                       # MQTT
        return any(f == topic for s in sessions.values() for f, _ in s.subs)
    emulated = getattr(broker, "subs", None)
    if isinstance(emulated, dict):                 # Google emulator
        return any(s["topic"] == topic for s in emulated.values())
    return True


def phase_serve_wire(dev, smi_line: str, cfg=None) -> dict:
    """Every backend the container reads from config, on the card:
    ``serving/model_serving.build_app`` with ``MODEL_PRESET=llama3_1b``
    (full width and depth, random bf16 weights from seed 0,
    ``serve_config``: 8 slots, prefix cache on), booted only through
    config keys against the port's own servers started here:
    ``DB_DIALECT=postgres`` on ``MiniPostgresServer`` (SCRAM-SHA-256),
    ``REDIS_MODE=network`` on ``MiniRedisServer``, ``PUBSUB_BACKEND=
    KAFKA`` on ``MiniKafkaBroker``, ``TRACE_EXPORTER=otlp`` and
    ``REMOTE_LOG_URL`` on a stdlib endpoint (``_WireEndpoint``).
    ``app.migrate`` makes the ``conversation`` table over the wire, and
    ``app.subscribe`` puts ``_job_handler`` (user code: bind, submit
    greedy, wait, a row through ``ctx.sql``, the text through
    ``ctx.redis``, the answer to ``answers``) on ``jobs-0`` ... ``jobs-3``.
    Checks, each also shown a planted fault it must reject:

    (a) the migration applied once over the wire, none the second time;
        health 200 with ``sql``, ``redis``, ``pubsub`` and the engine
        ``llama`` UP, ``sql``'s details the postgres client's; planted:
        the details of ``serve_ws``' sqlite store.
    (b) 16 jobs published, 4 per topic (``_ws_prompts``: 21-1501 tokens,
        64 new), while 8 ``/chat`` SSE streams run with other prompts:
        every job's answer tokens and digest equal its prompt's unary
        ``/chat`` answer, run gated afterwards; planted: an answer with a
        token dropped.
    (c) every job's row read back over the Postgres wire with its digest
        and token count, its text over RESP; planted: a row rewritten
        with a changed digest.
    (d) the group's committed offset on each topic is 4 after the wave;
        planted: the offsets read before it.
    (e) the collector got each job's span with the SQL and redis spans as
        its children, and the ``/chat`` streams' spans; the endpoint's
        switch to DEBUG reaches the app logger within two poll
        intervals; planted: the spans with one job's removed, and the
        level read before the switch.
    (f) the launch counters, zeroed before (b) and read after it: flash,
        paged decode, paged chunk and ``rope_kv_write`` rise; ``App.stop``
        leaves no connection open to the Kafka, Postgres and redis Mini
        servers within 2 s and stops the engine; planted: the counters
        read before the wave, the connections counted before the stop.
    (g) ``DB_DIALECT=mysql``, ``DB_DIALECT=oracle`` and ``PUBSUB_BACKEND=
        EVENTHUB|NATS|JETSTREAM|MQTT|GOOGLE``, each an app of its own on
        the same engine (``App.serve_model``) against its Mini server,
        carry a job to an answer and a row whose digest equals (b)'s for
        its prompt; planted: (b)'s answer to another prompt.

    Two greedy runs of one prompt in bf16 may part where the model's top
    tokens are within rounding of each other: a job's prefill can take
    a prefix hit and the chunk kernel where its reference took a batched
    flash prefill. (b) and (g) take a differing answer when it first
    differs at such a near tie (``_near_tie_judge``: float32 and bf16
    forwards of the model's plain path, ``cfg``, by default
    ``LlamaConfig.llama3_1b()``), and list each; (b)'s plants are a token
    dropped and a token replaced by its neighbour id.

    Also, ungated (unique prompts, engine running), job / stream / stream
    / job waves of the 16 prompts: a job's latency from publish to answer
    received p50 / p99 beside the ``/chat`` streams' (send to last event)
    and TTFT, the engine's TTFT, decode tokens/s, and the SQL and redis
    calls' wall time over the wire (the handler's own timing, the
    ``app_sql_stats`` / ``app_redis_stats`` medians, and 200 calls of each
    with no traffic, ``idle_ms``, then with the engine stopped)."""
    import copy
    import torch
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.datasource.postgres_wire import (MiniPostgresServer,
                                                         PostgresWire)
    from gofr_tpu_torch.datasource.redis_wire import (MiniRedisServer,
                                                      RedisWire)
    from gofr_tpu_torch.datasource.sql import SQL
    from gofr_tpu_torch.logging.logger import DEBUG
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write
    from gofr_tpu_torch.pubsub.kafka import KafkaClient, MiniKafkaBroker
    from gofr_tpu_torch.serving import model_serving
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "rope_kv_write": rope_kv_write}
    checks: dict = {}
    out: dict = {"phase": "serve_wire", "card": smi_line}
    greedy = {"max_tokens": WS_NEW, "temperature": 0}
    host = "127.0.0.1"
    pg = MiniPostgresServer(user=WIRE_USER, password=WIRE_PW,
                            auth="scram-sha-256")
    rd = MiniRedisServer()
    pg.start()
    rd.start()
    brokers = _LoopThread()
    kafka = MiniKafkaBroker()
    brokers.run(kafka.start())
    endpoint = _WireEndpoint()
    teardown: list = []
    app = model_serving.build_app(DictConfig({
        "MODEL_PRESET": "llama3_1b", "HTTP_HOST": host, "HTTP_PORT": "0",
        "METRICS_PORT": "0", "APP_NAME": "serve-wire",
        "DB_DIALECT": "postgres", "DB_HOST": host, "DB_PORT": str(pg.port),
        "DB_USER": WIRE_USER, "DB_PASSWORD": WIRE_PW, "DB_NAME": WIRE_DB,
        "REDIS_HOST": host, "REDIS_PORT": str(rd.port),
        "REDIS_MODE": "network", "PUBSUB_BACKEND": "KAFKA",
        "PUBSUB_BROKER": f"{host}:{kafka.port}",
        "KAFKA_CONSUMER_GROUP": WIRE_GROUP, "TRACE_EXPORTER": "otlp",
        "TRACER_URL": f"http://{host}:{endpoint.port}",
        "REMOTE_LOG_URL": f"http://{host}:{endpoint.port}/level",
        "REMOTE_LOG_FETCH_INTERVAL": str(WIRE_POLL_S)}), device=dev)
    engine = app.container.get_model(model_serving.MODEL_NAME)
    tok = ByteTokenizer()
    cfg = cfg or LlamaConfig.llama3_1b()
    judge = _near_tie_judge(engine.params, cfg)
    made: list = []
    inner_submit = engine.submit

    def submit(*args, **kwargs):
        made.append(inner_submit(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    op_ms: dict = {"sql": [], "redis": []}
    app_loop: dict = {}
    loop = thread = None
    try:
        # (a) the migration over the wire, before the app starts
        first = app.migrate(_wire_migrations())
        again = app.migrate(_wire_migrations())
        for topic in WIRE_TOPICS:
            app.subscribe(topic, _job_handler(engine, tok, app_loop, op_ms))
        loop, thread = _boot_app(app, "serve_wire")
        app_loop["loop"] = loop
        aport = app.port
        answers = _Answers(brokers, lambda cid: KafkaClient(
            f"{host}:{kafka.port}", group_id=cid, client_id=cid), "smoke")
        teardown.append(answers.close)
        health = _http_json(aport, "GET", "/.well-known/health")
        sql_details = (health[2]["data"]["checks"].get("sql") or {}).get(
            "details")
        want = {"host": host, "port": pg.port, "database": WIRE_DB}
        sqlite = SQL(dialect="sqlite", database=":memory:")
        sqlite.connect()
        planted_details = sqlite.health_check().get("details")
        sqlite.close()
        checks["a_boot"] = (
            ([] if (first, again) == ([1], []) else
             [f"applied {first} then {again}"])
            + _wire_health_faults(health, sql_details, want),
            _wire_health_faults(health, planted_details, want))
        out["a"] = {"applied": first, "again": again,
                    "sql_client": type(app.container.sql).__name__,
                    "sql_details": sql_details,
                    "health": {k: v.get("status") for k, v in
                               health[2]["data"]["checks"].items()}}

        # (b) the job wave beside 8 /chat streams, then unary /chat gated
        before_offsets = {t: kafka.groups.get(WIRE_GROUP) and kafka.groups[
            WIRE_GROUP].offsets.get((t, 0)) for t in WIRE_TOPICS}
        for fn in counters.values():
            fn.launches = 0
        wave_base = len(made)
        prompts = _ws_prompts()
        jobs = [{"id": f"job-{i}", "prompt": p, **greedy}
                for i, p in enumerate(prompts)]
        ids = [j["id"] for j in jobs]
        streams: list = [None] * 8

        def stream(i, prompt):
            streams[i] = _sse_call(aport, "/chat", {
                "prompt": prompt, **greedy, "stream": True})
        workers = [threading.Thread(target=stream, args=(i, p)) for i, p in
                   enumerate(_ws_prompts("stream ")[:8])]
        for w in workers:
            w.start()
        for i, topic in enumerate(WIRE_TOPICS):
            answers.publish(topic, jobs[i::len(WIRE_TOPICS)])
        if not answers.wait(ids):
            raise AssertionError(f"serve_wire: answers {sorted(answers.got)}")
        for w in workers:
            w.join(timeout=600)
        launches = {name: int(fn.launches) for name, fn in counters.items()}
        got = {i: answers.got[i][1] for i in ids}

        engine.stop()
        engine.waiting.reopen()
        base = len(made)
        unary: list = [None] * len(prompts)

        def call(i, prompt):
            unary[i] = _http_json(aport, "POST", "/chat",
                                  {"prompt": prompt, **greedy})
        callers = []
        for i, p in enumerate(prompts):
            callers.append(threading.Thread(target=call, args=(i, p)))
            callers[-1].start()
            deadline = time.time() + 60
            while len(made) < base + i + 1 and time.time() < deadline:
                time.sleep(0.001)
        engine.start()
        for c in callers:
            c.join(timeout=600)
        u_reqs = made[base:]
        dropped = copy.deepcopy(got)
        del dropped[ids[2]]["tokens"][5]
        # a token replaced by its neighbour id: the near-tie rule must
        # not pass an arbitrary divergence
        changed = copy.deepcopy(got)
        changed[ids[2]]["tokens"][5] = (changed[ids[2]]["tokens"][5] + 1) \
            % cfg.vocab_size
        stream_faults = [f"stream_{i}" for i, s in enumerate(streams)
                         if s is None or s.get("status") != 200
                         or not s.get("terminal")]
        ties: dict = {}
        plants = [_wire_answer_faults(bad, ids, unary, u_reqs, judge, {})
                  for bad in (dropped, changed)]
        checks["b_job_wave"] = (
            _wire_answer_faults(got, ids, unary, u_reqs, judge, ties)
            + stream_faults, sum(plants, []) if all(plants) else [])
        by_prompt_req = {tuple(r.prompt_tokens): r
                         for r in made[wave_base:base]}
        out["b"] = {"jobs": len(got), "streams": len(streams),
                    "prompt_tokens": [len(r.prompt_tokens) for r in u_reqs],
                    "tokens_0": got[ids[0]]["tokens"][:8],
                    "diverged": _wire_divergence(got, ids, u_reqs,
                                                 by_prompt_req),
                    "near_ties": ties}

        # (c) read back over the wire, with clients of the phase's own
        reader = PostgresWire(host=host, port=pg.port, user=WIRE_USER,
                              password=WIRE_PW, database=WIRE_DB)
        reader.connect()
        cache = RedisWire(host=host, port=rd.port)
        cache.connect()

        def read_back(job_ids):
            rows = {r["job"]: r for r in reader.query(
                "SELECT job, prompt_tokens, n_generated, digest FROM "
                "conversation")}
            return ({i: rows.get(i) for i in job_ids},
                    {i: cache.get(f"job:{i}") for i in job_ids})
        rows, texts = read_back(ids)
        reader.exec("INSERT INTO conversation (job, topic, prompt_tokens, "
                    "n_generated, digest) VALUES ($1, $2, $3, $4, $5)",
                    "planted", "none", 0, WS_NEW, "0" * 16)
        planted_rows, _ = read_back(["planted"])
        checks["c_read_back"] = (
            _wire_store_faults(got, rows, texts, tok.decode),
            _wire_store_faults({"planted": got[ids[0]]}, planted_rows,
                               {"planted": texts[ids[0]]}, tok.decode))
        out["c"] = {"rows": sum(r is not None for r in rows.values()),
                    "row_0": rows.get(ids[0])}

        # (d) the group's commits (fire-and-forget after each success)
        def committed():
            group = kafka.groups.get(WIRE_GROUP)
            return {t: group.offsets.get((t, 0)) if group else None
                    for t in WIRE_TOPICS}
        deadline = time.time() + 5
        while _wire_offset_faults(committed(), 4) and time.time() < deadline:
            time.sleep(0.01)
        offsets = committed()
        checks["d_commits"] = (_wire_offset_faults(offsets, 4),
                               _wire_offset_faults(before_offsets, 4))
        out["d"] = {"offsets": offsets, "before": before_offsets}

        # ungated timing, unique prompts: jobs / streams / streams / jobs
        timing: dict = {"jobs": [], "chat": []}
        for i, side in enumerate(("jobs", "chat", "chat", "jobs")):
            asks = _ws_prompts(f"t{i} ")
            base = len(made)
            if side == "jobs":
                wave = [{"id": f"t{i}-{j}", "prompt": p, **greedy}
                        for j, p in enumerate(asks)]
                for k, topic in enumerate(WIRE_TOPICS):
                    answers.publish(topic, wave[k::len(WIRE_TOPICS)])
                wave_ids = [j["id"] for j in wave]
                if not answers.wait(wave_ids):
                    raise AssertionError("serve_wire: a timing wave's "
                                         "answers did not come")
                run = {"latency_s": _pcts([answers.got[j][0]
                                           - answers.sent[j]
                                           for j in wave_ids])}
            else:
                runs: list = [None] * len(asks)

                def ask(j, prompt, runs=runs):
                    runs[j] = _sse_call(aport, "/chat", {
                        "prompt": prompt, **greedy, "stream": True})
                askers = [threading.Thread(target=ask, args=(j, p))
                          for j, p in enumerate(asks)]
                for w in askers:
                    w.start()
                for w in askers:
                    w.join(timeout=600)
                run = _sse_timing(runs)
                run["latency_s"] = _pcts([r["events"][-1][0] for r in runs
                                          if r and r["events"]])
            run["engine_ttft_s"] = _pcts([r.ttft_ms / 1000.0
                                          for r in made[base:]
                                          if r.ttft_ms is not None])
            run["engine_decode_tokens_per_s"] = _engine_rate(made[base:])
            timing[side].append(run)
        metrics = app.container.metrics
        out["timing"] = {
            **timing, "card": smi_line,
            "sql_insert_ms": _pcts(op_ms["sql"]),
            "redis_set_ms": _pcts(op_ms["redis"]),
            "app_sql_stats_p50_ms": _hist_p50_ms(metrics, "app_sql_stats"),
            "app_redis_stats_p50_ms": _hist_p50_ms(metrics,
                                                   "app_redis_stats"),
            "definition": "16 jobs published at once, 4 per topic (one in "
            "flight per topic), beside 16 /chat streams at once, on 8 "
            "slots, 64 tokens each, prompts 21-1501 tokens; job latency "
            "from the publish call to the answer's arrival at the phase's "
            "consumer, stream latency from the send to the last event"}

        # the same wire calls with no traffic: 200 of each from this
        # thread, to part the protocol's cost from the wait for the GIL
        # under a wave (the Mini servers live in this process)
        def op_ms_idle(fn) -> dict:
            times = []
            for i in range(200):
                t0 = time.perf_counter()
                fn(i)
                times.append((time.perf_counter() - t0) * 1000.0)
            return _pcts(times)
        sql_c, redis_c = app.container.sql, app.container.redis

        def idle_ops(tag: str) -> dict:
            return {
                "sql_select": op_ms_idle(lambda i: sql_c.query(
                    "SELECT 1 AS one")),
                "sql_insert": op_ms_idle(lambda i: sql_c.exec(
                    "INSERT INTO conversation (job, topic, prompt_tokens, "
                    "n_generated, digest) VALUES ($1, $2, $3, $4, $5)",
                    f"{tag}-{i}", tag, 0, 0, "")),
                "redis_set": op_ms_idle(lambda i: redis_c.set(
                    f"{tag}:{i}", "x")),
                "redis_get": op_ms_idle(lambda i: redis_c.get(
                    f"{tag}:{i}"))}
        out["timing"]["idle_ms"] = idle_ops("idle")
        # and with the engine's thread stopped too
        engine.stop()
        out["timing"]["idle_ms_engine_stopped"] = idle_ops("stopped")
        engine.start()

        # (e) the spans at the collector, and the remote log level
        def span_faults():
            return _wire_span_faults(endpoint.spans(), ids, len(streams))
        deadline = time.time() + 15
        while span_faults() and time.time() < deadline:
            time.sleep(0.1)
        spans = endpoint.spans()
        job_3 = next((s for s in spans if s["name"] == f"job {ids[3]}"),
                     {})
        planted_spans = [s for s in spans
                         if s.get("traceId") != job_3.get("traceId")]
        checks["e_spans"] = (_wire_span_faults(spans, ids, len(streams)),
                             _wire_span_faults(planted_spans, ids,
                                               len(streams)))
        before = {"after": "DEBUG" if app.logger.level == DEBUG else "INFO",
                  "switched_s": None}
        endpoint.level = "DEBUG"
        t0 = time.perf_counter()
        switched = None
        while time.perf_counter() - t0 < 3 * WIRE_POLL_S:
            if app.logger.level == DEBUG:
                switched = time.perf_counter() - t0
                break
            time.sleep(0.005)
        level = {"after": "DEBUG" if app.logger.level == DEBUG else "INFO",
                 "switched_s": switched}
        checks["e_level"] = (_wire_level_faults(level),
                             _wire_level_faults(before))
        out["e"] = {"spans": len(spans), "exported": getattr(
            app.container.tracer.exporter, "sent", None),
            "job_0_children": sorted(
                s["name"] for s in spans
                if s.get("parentSpanId") == next(
                    (j["spanId"] for j in spans
                     if j["name"] == f"job {ids[0]}"), None)),
            "level": level, "level_polls": endpoint.gets}

        # (f) the kernels of the wave, then the stop
        checks["f_launches"] = (_launch_faults(launches),
                                _launch_faults(dict.fromkeys(launches, 0)))
        out["launches"] = launches
        teardown.remove(answers.close)
        answers.close()
        reader.close()
        cache.close()
        ports = {"kafka": kafka.port, "postgres": pg.port, "redis": rd.port}
        open_before = {k: _open_connections(p) for k, p in ports.items()}
        _stop_app(app, loop, thread)
        t_stop = time.perf_counter()
        while any(_open_connections(p) for p in ports.values()) and \
                time.perf_counter() - t_stop < 2.0:
            time.sleep(0.01)
        stopped = {"open": {k: _open_connections(p) for k, p in
                            ports.items()},
                   "engine_running": engine._running}
        checks["f_stop"] = (_wire_stop_faults(stopped), _wire_stop_faults(
            {**stopped, "open": open_before}))
        out["f"] = {**stopped, "open_before": open_before}

        # (g) the other backends, each an app of its own on this engine
        engine.submit = inner_submit
        # one job a backend keeps the whole script near its time before
        # this phase; its plant is (b)'s answer to another prompt
        g_prompts = prompts[:1]
        by_prompt = {g_prompts[0]: got[ids[0]]}
        wrong = {g_prompts[0]: got[ids[1]]}
        g_faults, g_planted, g_out, g_ties = [], [], {}, {}
        for name in ("mysql", "oracle", "EVENTHUB", "NATS", "JETSTREAM",
                     "MQTT", "GOOGLE"):
            t_g = time.perf_counter()
            env, broker, started, client = _wire_backend(
                name, brokers, {"postgres": pg})
            g_app = App(config=DictConfig({
                **env, "HTTP_HOST": host, "HTTP_PORT": "0",
                "METRICS_PORT": "0", "APP_NAME": f"serve-wire-{name}"}))
            g_app.serve_model(model_serving.MODEL_NAME, engine, tok)
            g_app.migrate(_wire_migrations())
            g_loop: dict = {}
            g_app.subscribe("g-jobs", _job_handler(engine, tok, g_loop,
                                                   {"sql": [], "redis": []}))
            g_answers = g_thread = None
            try:
                g_answers = _Answers(brokers, client, "smoke")
                g_loop["loop"], g_thread = _boot_app(g_app, name)
                deadline = time.time() + 30
                while not (_wire_subscribed(broker, "g-jobs") and
                           _wire_subscribed(broker, "answers")) and \
                        time.time() < deadline:
                    time.sleep(0.01)
                g_jobs = [{"id": f"{name}-{i}", "prompt": p, **greedy}
                          for i, p in enumerate(g_prompts)]
                g_answers.publish("g-jobs", g_jobs)
                g_ids = [j["id"] for j in g_jobs]
                g_answers.wait(g_ids, timeout_s=120)
                g_got = {p: (g_answers.got.get(i) or (None, None))[1]
                         for i, p in zip(g_ids, g_prompts)}
                sql = g_app.container.sql
                # oracle names columns in upper case and sends text
                g_rows = {}
                for r in sql.query("SELECT job, n_generated, digest FROM "
                                   "conversation"):
                    r = {k.lower(): v for k, v in r.items()}
                    g_rows[r["job"]] = {**r, "n_generated": int(
                        r["n_generated"])}
                g_texts = {i: g_app.container.redis.get(f"job:{i}")
                           for i in g_ids}
                mine = {i: g_got[p] for i, p in zip(g_ids, g_prompts)
                        if g_got[p] is not None}
                g_faults += _g_answer_faults(name, g_got, by_prompt,
                                             tok.encode, judge, g_ties)
                g_faults += [f"{name}: {f}" for f in (
                    _wire_store_faults(mine, g_rows, g_texts, tok.decode)
                    + ([] if len(mine) == len(g_prompts)
                       else ["answers missing"]))]
                g_planted += _g_answer_faults(name, g_got, wrong,
                                              tok.encode, judge, {})
                g_out[name] = {"client": type(g_app.container.pubsub
                                              ).__name__,
                               "sql": type(sql).__name__,
                               "answers": len(mine),
                               "wall_s": time.perf_counter() - t_g}
            finally:
                if g_answers is not None:
                    g_answers.close()
                if g_thread is not None:
                    _stop_app(g_app, g_loop["loop"], g_thread)
                brokers.run(broker.close())
                for server in started:
                    server.close()
        checks["g_backends"] = (g_faults, g_planted)
        out["g"] = {**g_out, "near_ties": g_ties}
        out["near_tie_judge_s"] = judge.seconds()
    finally:
        engine.submit = inner_submit
        for fn in teardown:
            fn()
        if loop is not None and loop.is_running():
            _stop_app(app, loop, thread)
        brokers.run(kafka.close())
        brokers.close()
        endpoint.close()
        pg.close()
        rd.close()
        judge.release()
    del app, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_wire: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out["launches"]


# ----------------------------------------------------------- serve_stores
STORES_USERS = ("ada", "grace", "alan", "edsger")
STORES_USER, STORES_PW = "gofr", "store-secret"
#: the object stores' credentials (S3's SigV4 pair, GCS's bearer token,
#: Azure's SharedKey account key, base64)
STORES_AK, STORES_SK = "smoke-access", "smoke-secret"
STORES_TOKEN = "smoke-token"
STORES_AZ_KEY = "c21va2UtYWNjb3VudC1rZXk="
#: the stores a handler writes each answer to, in order
STORES_MAIN = ("mongo", "cassandra", "clickhouse", "elasticsearch", "s3",
               "influxdb", "dgraph")
#: the other wire clients, each given one answer to keep
STORES_OTHER = ("solr", "couchbase", "scylladb", "arangodb", "surrealdb",
                "opentsdb", "gcs", "azure_blob", "dynamo")


class _S3Engine:
    """The object engine an ``S3FileSystem`` reads and writes through
    (``put``, ``get``, ``delete``, ``list``, ``exists``, ``stats``), over
    an ``S3Wire``: ``ctx.file`` keeps its objects in S3 over SigV4. The
    file system's bucket is the wire client's."""

    def __init__(self, wire) -> None:
        self.wire = wire

    def put(self, bucket: str, key: str, data: bytes) -> None:
        self.wire.put_object(key, data)

    def get(self, bucket: str, key: str) -> bytes:
        return self.wire.get_object(key)

    def delete(self, bucket: str, key: str) -> bool:
        if not self.wire.exists(key):
            return False
        self.wire.delete_object(key)
        return True

    def list(self, bucket: str, prefix: str = "") -> list:
        return [(o["Key"], o["Size"], 0.0)
                for o in self.wire.list_objects(prefix)]

    def exists(self, bucket: str, key: str) -> bool:
        return self.wire.exists(key)

    def stats(self) -> dict:
        return {"objects": len(self.wire.list_objects())}


def _stores_migrations(fail: bool = False) -> dict:
    """Version 1 makes the ``answers`` tables in Cassandra and ClickHouse
    and a schema document in Mongo, version 2 bumps the document; with
    ``fail`` a version 3 raises before it writes."""
    from gofr_tpu_torch.migrations import Migrate

    def v1(ds):
        ds.cassandra.exec("CREATE TABLE answers (id TEXT PRIMARY KEY, "
                          "user TEXT, n_generated INTEGER, digest TEXT, "
                          "text TEXT)")
        ds.clickhouse.exec("CREATE TABLE answers (id TEXT, prompt_tokens "
                           "INTEGER, n_generated INTEGER, digest TEXT)")
        ds.mongo.insert_one("schema", {"_id": "answers", "version": 1})

    def v2(ds):
        ds.mongo.update_many("schema", {"_id": "answers"},
                             {"$set": {"version": 2}})

    out = {1: Migrate(up=v1), 2: Migrate(up=v2)}
    if fail:
        def v3(ds):
            raise RuntimeError("planted: version 3 fails")
        out[3] = Migrate(up=v3)
    return out


def _stores_ledgers(c) -> dict:
    """Each wire store's migration ledger, and Mongo's schema version."""
    q = "SELECT version FROM gofr_migrations ORDER BY version"
    schema = c.mongo.find_one("schema", {"_id": "answers"}) or {}
    return {"cassandra": [int(r["version"]) for r in c.cassandra.query(q)],
            "clickhouse": [int(r["version"]) for r in c.clickhouse.select(q)],
            "mongo": sorted(int(d["version"]) for d in
                            c.mongo.find("gofr_migrations")),
            "schema": schema.get("version")}


def _stores_migrate_faults(run: dict) -> list:
    """(a): versions 1-2 applied once over the wires, none the second
    time, version 3's raise recorded in no ledger; schema version 2."""
    out = []
    if (run["first"], run["again"]) != ([1, 2], []):
        out.append(f"applied {run['first']} then {run['again']}")
    if not run["v3_raised"]:
        out.append("v3 did not raise")
    for store in ("cassandra", "clickhouse", "mongo"):
        if run["ledgers"][store] != [1, 2]:
            out.append(f"{store} ledger {run['ledgers'][store]}")
    if run["ledgers"]["schema"] != 2:
        out.append(f"schema {run['ledgers']['schema']}")
    return out


def _stores_health_faults(health: tuple, names: tuple) -> list:
    """(a): health 200 UP, every store of ``names`` and the engine
    ``llama`` UP."""
    data = health[2].get("data") or {}
    checks = data.get("checks") or {}
    out = [] if health[0] == 200 and data.get("status") == "UP" \
        else [f"health {health[0]} {data.get('status')}"]
    out += [f"{n} not UP" for n in names
            if (checks.get(n) or {}).get("status") != "UP"]
    engines = ((checks.get("tpu") or {}).get("details") or {}).get(
        "engines") or {}
    if (engines.get("llama") or {}).get("status") != "UP":
        out.append("engine not UP")
    return out


def _answer_handler(engine, tok, op_ms: dict):
    """The user's ``POST /answer``, plain (it runs on the app's handler
    pool): it binds ``{"id", "user", "seq", "prompt", "max_tokens"}``,
    submits greedy to the engine behind ``/chat`` and waits, then keeps
    the answer in every store the app holds, each write timed into
    ``op_ms``: the document in Mongo, a row in Cassandra and in
    ClickHouse, the text in Elasticsearch and as an object in S3
    (``ctx.file``), its token count as a point in InfluxDB (time
    ``seq``), an edge user -> conversation in Dgraph."""
    from gofr_tpu_torch.serving.engine import SamplingParams

    def answer(ctx):
        body = ctx.bind()
        aid, user = body["id"], body["user"]
        prompt_tokens = tok.encode(body["prompt"])
        req = engine.submit(prompt_tokens, SamplingParams(
            temperature=0.0, max_new_tokens=int(body["max_tokens"])))
        if not req.done.wait(600) or req.error:
            raise RuntimeError(f"{aid}: {req.error or 'timed out'}")
        tokens, digest = list(req.generated), req.digest
        text = tok.decode(tokens)
        writes = {
            "mongo": lambda: ctx.mongo.insert_one("answers", {
                "_id": aid, "user": user, "tokens": tokens,
                "digest": digest, "text": text}),
            "cassandra": lambda: ctx.cassandra.exec(
                "INSERT INTO answers (id, user, n_generated, digest, text) "
                "VALUES (?, ?, ?, ?, ?)", aid, user, len(tokens), digest,
                text),
            "clickhouse": lambda: ctx.clickhouse.exec(
                "INSERT INTO answers VALUES (?, ?, ?, ?)", aid,
                len(prompt_tokens), len(tokens), digest),
            "elasticsearch": lambda: ctx.elasticsearch.index(
                "answers", aid, {"user": user, "text": text}),
            "s3": lambda: ctx.file.create(f"answers/{aid}.txt", text),
            "influxdb": lambda: ctx.influxdb.write_point(
                "tokens", "generated", float(body["seq"]),
                {"n": float(len(tokens))}, {"id": aid, "user": user}),
            "dgraph": lambda: ctx.dgraph.mutate({
                "uid": "_:u", "name": user,
                "asked": [{"name": aid, "digest": digest}]})}
        ms = {}
        for name in STORES_MAIN:
            t0 = time.perf_counter()
            writes[name]()
            ms[name] = (time.perf_counter() - t0) * 1000.0
            op_ms.setdefault(name, []).append(ms[name])
        return {"id": aid, "user": user, "tokens": tokens, "digest": digest,
                "prompt_tokens": len(prompt_tokens), "store_ms": ms}
    return answer


def _es_word(text: str) -> str:
    """The longest word of ``text`` as the Elasticsearch analyzer splits
    it (lower-cased runs of letters and digits)."""
    words = "".join(c.lower() if c.isalnum() else " " for c in text).split()
    return max(words, key=len) if words else ""


def _stores_read_back(c, s3, ids: list) -> dict:
    """Each answer as the app's stores give it back over their wires:
    Mongo's document by id, Cassandra's and ClickHouse's rows by
    ``SELECT``, the ids Elasticsearch finds for the longest word of the
    stored text, S3's object, InfluxDB's points of the answer and the sum
    over all, Dgraph's conversations of each user."""
    rows = {r["id"]: r for r in c.cassandra.query(
        "SELECT id, user, n_generated, digest, text FROM answers")}
    ch = {r["id"]: r for r in c.clickhouse.select(
        "SELECT id, prompt_tokens, n_generated, digest FROM answers")}
    out: dict = {"answers": {}, "influx_sum": c.influxdb.aggregate(
        "tokens", "generated", "n", "sum"), "dgraph": {}}
    for user in STORES_USERS:
        out["dgraph"][user] = sorted(
            a["name"] for node in c.dgraph.query({"name": user},
                                                 expand="asked")
            for a in node.get("asked") or [])
    for aid in ids:
        doc = c.mongo.find_one("answers", {"_id": aid})
        text = (doc or {}).get("text", "")
        hits = c.elasticsearch.search("answers", {"match": {
            "text": _es_word(text)}}, size=64)["hits"]["hits"]
        try:
            obj = s3.get_object(f"answers/{aid}.txt")
        except Exception as exc:  # noqa: BLE001 — a missing object
            obj = repr(exc)
        out["answers"][aid] = {
            "mongo": doc, "cassandra": rows.get(aid),
            "clickhouse": ch.get(aid), "es_hits": [h["_id"] for h in hits],
            "s3": obj, "influx": c.influxdb.query(
                "tokens", "generated", "n", tags={"id": aid})}
    return out


def _stores_read_faults(answers: dict, got: dict, decode) -> list:
    """(c): every answer read back from every store: Mongo's document
    holds its tokens, digest and text; Cassandra's and ClickHouse's rows
    its token count and digest (Cassandra's its text too); Elasticsearch
    finds it by a word of its text; S3's object is its text; its InfluxDB
    point is its token count and the points sum to the tokens generated;
    Dgraph holds the edge from its user to it."""
    out = []
    for aid, ans in answers.items():
        back = got["answers"].get(aid) or {}
        text = decode(ans["tokens"])
        n, digest = len(ans["tokens"]), ans["digest"]
        doc = back.get("mongo") or {}
        if doc.get("tokens") != ans["tokens"] or doc.get("digest") != \
                digest or doc.get("text") != text:
            out.append(f"{aid} mongo")
        row = back.get("cassandra") or {}
        if (row.get("n_generated"), row.get("digest"), row.get("text")) \
                != (n, digest, text):
            out.append(f"{aid} cassandra")
        row = back.get("clickhouse") or {}
        if (row.get("n_generated"), row.get("digest")) != (n, digest):
            out.append(f"{aid} clickhouse")
        if aid not in back.get("es_hits", []):
            out.append(f"{aid} elasticsearch")
        if back.get("s3") != text.encode():
            out.append(f"{aid} s3")
        if [v for _, v in back.get("influx") or []] != [float(n)]:
            out.append(f"{aid} influxdb")
        if aid not in got["dgraph"].get(ans["user"], []):
            out.append(f"{aid} dgraph")
    total = float(sum(len(a["tokens"]) for a in answers.values()))
    if got["influx_sum"] != total:
        out.append(f"influxdb sum {got['influx_sum']} != {total}")
    return out


def _keep_one(clients: dict, answer: dict, decode) -> dict:
    """(d): one answer kept by each other wire client and read back: what
    each gave back, or its typed error."""
    aid, n = answer["id"], len(answer["tokens"])
    text = decode(answer["tokens"])
    c = clients

    def scylla():
        c["scylladb"].exec("CREATE TABLE IF NOT EXISTS kept (id TEXT "
                           "PRIMARY KEY, text TEXT)")
        c["scylladb"].exec("INSERT INTO kept (id, text) VALUES (?, ?)",
                           aid, text)
        return c["scylladb"].query("SELECT text FROM kept WHERE id = ?",
                                   aid)[0]["text"]

    def arango():
        key = c["arangodb"].create_document("answers", {"id": aid,
                                                        "text": text})
        return c["arangodb"].get_document("answers", key)["text"]

    def tsdb():
        c["opentsdb"].put_data_points([{"metric": "answer.tokens",
                                        "timestamp": 1, "value": float(n),
                                        "tags": {"id": aid}}])
        return int(c["opentsdb"].query("answer.tokens", aggregator="sum",
                                       tags={"id": aid})["value"])

    steps = {
        "solr": lambda: (c["solr"].add("answers", [{"id": aid,
                                                    "text": text}]),
                         c["solr"].search("answers", f"id:{aid}")[
                             "response"]["docs"][0]["text"])[1],
        "couchbase": lambda: (c["couchbase"].upsert("answers", aid, {
            "text": text}), c["couchbase"].get("answers", aid)["text"])[1],
        "scylladb": scylla, "arangodb": arango,
        "surrealdb": lambda: (c["surrealdb"].create(f"answer:{aid}", {
            "text": text}), c["surrealdb"].select(f"answer:{aid}")[0][
            "text"])[1],
        "opentsdb": tsdb,
        "gcs": lambda: (c["gcs"].upload(f"answers/{aid}.txt",
                                        text.encode()),
                        c["gcs"].download(f"answers/{aid}.txt").decode())[1],
        "azure_blob": lambda: (c["azure_blob"].upload_blob(
            f"answers/{aid}.txt", text.encode()), c["azure_blob"]
            .download_blob(f"answers/{aid}.txt").decode())[1],
        "dynamo": lambda: (c["dynamo"].set(f"answer:{aid}", text),
                           c["dynamo"].get(f"answer:{aid}"))[1]}
    out = {}
    for name in STORES_OTHER:
        try:
            out[name] = steps[name]()
        except Exception as exc:  # noqa: BLE001 — the typed error is kept
            out[name] = {"error": type(exc).__name__,
                         "message": str(exc)[:160]}
    return out


def _keep_faults(kept: dict, answer: dict, decode) -> list:
    """(d): each other client gave back the answer's text (OpenTSDB its
    token count)."""
    text = decode(answer["tokens"])
    want = {name: text for name in STORES_OTHER}
    want["opentsdb"] = len(answer["tokens"])
    return [f"{name}: {kept.get(name)!r:.120}" for name in STORES_OTHER
            if kept.get(name) != want[name]]


def _server_ports(server) -> list:
    return [getattr(server, name) for name in ("port", "kv_port",
                                               "query_port")
            if isinstance(getattr(server, name, None), int)]


def phase_serve_stores(dev, smi_line: str, cfg=None) -> dict:
    """The breadth stores on the card: ``llama3_1b`` (full width and
    depth, random bf16 weights from seed 0; ``cfg`` another config)
    through ``App.serve_model`` with ``serve_config`` (8 slots, prefix
    cache on), and the port's Mini servers on loopback, attached as a
    user attaches them: ``add_mongo(MongoWire)``, ``add_cassandra``,
    ``add_clickhouse``, ``add_elasticsearch``, ``add_influxdb``,
    ``add_dgraph`` and ``add_file_store`` of an ``S3FileSystem`` over
    ``S3Wire`` (``_S3Engine``); then Solr, Couchbase, ``ScyllaWire``,
    Arango, Surreal, OpenTSDB and ``DynamoKV`` in their slots, GCS and
    Azure Blob held by the phase. ``POST /answer`` is the user's handler
    (``_answer_handler``): it generates an answer and keeps it in the
    seven stores. Checks, each also shown a planted fault it must reject:

    (a) migrations over the Cassandra, ClickHouse and Mongo wires:
        versions 1-2 once, none the second time, a version 3 that raises
        recorded in no ledger (these stores have no cross-statement
        transaction: the ledger row is what a failing version leaves
        out); health 200 UP listing every store and the engine; planted:
        a ledger row 3 written into Mongo behind the runner, and a
        Mongo client on a dead port in the health.
    (b) 16 ``/answer`` requests in flight on the 8 slots, gated
        (``_ws_prompts``, the last replaced by a prompt that extends the
        900-token one: a prefix hit; the 1501-token one walks in
        chunks), then the same prompts as unary ``/chat``, gated: each
        answer's tokens and digest equal ``/chat``'s, or first differ at
        a near tie (``_near_tie_judge``); prefix hits rise; planted: an
        answer with a token dropped, and one with another's digest.
    (c) every answer read back over the wire from every store
        (``_stores_read_faults``); planted: Mongo's document and
        Cassandra's row of one answer rewritten behind the app's clients
        by clients of the phase's own.
    (d) the other nine wire clients each keep one answer and give it
        back; planted: the same through a GCS client with a wrong token,
        an Azure one with a wrong SharedKey and a Dynamo one with a wrong
        SigV4 secret, which answer with their typed errors.
    (e) the launch counters, zeroed before (b)'s wave and read after it:
        flash, paged decode, paged chunk and ``rope_kv_write`` rise;
        ``App.stop`` closes every client: no Mini server holds an open
        connection within 2 s, and the engine stops; planted: the
        counters read before the wave, the connections counted before
        the stop.

    Also, ungated (unique prompts, engine running), ``/answer`` /
    ``/chat`` stream / stream / ``/answer`` waves of 16: client latency,
    the engine's TTFT and decode tokens/s; each store's write time in a
    handler under load (p50 / p99), each store's ``app_<store>_stats``
    p50, and 50 writes and reads of each store with no traffic."""
    import copy
    import torch
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.datasource import (arango_wire, azure_blob_wire,
                                           cassandra_wire, clickhouse_wire,
                                           couchbase_wire, dgraph_wire,
                                           dynamo_wire, es_wire, gcs_wire,
                                           influx_wire, mongo_wire,
                                           opentsdb_wire, s3_wire, solr_wire,
                                           surreal_wire)
    from gofr_tpu_torch.datasource.object_store import S3FileSystem
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write
    from gofr_tpu_torch.serving.app import build_engine
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "rope_kv_write": rope_kv_write}
    checks: dict = {}
    out: dict = {"phase": "serve_stores", "card": smi_line}
    greedy = {"max_tokens": WS_NEW, "temperature": 0}
    host = "127.0.0.1"
    servers = {
        "mongo": mongo_wire.MiniMongoServer(),
        "cassandra": cassandra_wire.MiniCassandraServer(
            keyspace="gofr", user=STORES_USER, password=STORES_PW),
        "clickhouse": clickhouse_wire.MiniClickhouseServer(),
        "elasticsearch": es_wire.MiniESServer(),
        "s3": s3_wire.MiniS3Server(access_key=STORES_AK,
                                   secret_key=STORES_SK),
        "influxdb": influx_wire.MiniInfluxServer(),
        "dgraph": dgraph_wire.MiniDgraphServer(),
        "solr": solr_wire.MiniSolrServer(),
        "couchbase": couchbase_wire.MiniCouchbaseServer(
            username=STORES_USER, password=STORES_PW),
        "scylladb": cassandra_wire.MiniCassandraServer(keyspace="gofr"),
        "arangodb": arango_wire.MiniArangoServer(username=STORES_USER,
                                                 password=STORES_PW),
        "surrealdb": surreal_wire.MiniSurrealServer(username=STORES_USER,
                                                    password=STORES_PW),
        "opentsdb": opentsdb_wire.MiniOpenTSDBServer(),
        "gcs": gcs_wire.MiniGCSServer(token=STORES_TOKEN),
        "azure_blob": azure_blob_wire.MiniAzureBlobServer(
            account="gofr", key_b64=STORES_AZ_KEY),
        "dynamo": dynamo_wire.MiniDynamoServer(access_key=STORES_AK,
                                               secret_key=STORES_SK)}
    started: list = []
    cfg = cfg or LlamaConfig.llama3_1b()
    engine = build_engine(cfg, device=dev)
    tok = _PrintableTokenizer()
    judge = _near_tie_judge(engine.params, cfg)
    made: list = []
    inner_submit = engine.submit

    def submit(*args, **kwargs):
        made.append(inner_submit(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    op_ms: dict = {}
    own: list = []          # the phase's own clients, closed before (e)
    loop = thread = None
    app = None
    try:
        for server in servers.values():
            server.start()
            started.append(server)
        p = {name: s.port for name, s in servers.items()
             if name != "couchbase"}

        def at(name: str) -> str:
            return f"{host}:{p[name]}"
        app = App(config=DictConfig({
            "HTTP_HOST": host, "HTTP_PORT": "0", "METRICS_PORT": "0",
            "APP_NAME": "serve-stores"}))
        app.serve_model("llama", engine, tok)
        c = app.container
        c.add_mongo(mongo_wire.MongoWire(host=host, port=p["mongo"],
                                         database="gofr"))
        c.add_cassandra(cassandra_wire.CassandraWire(
            host=host, port=p["cassandra"], keyspace="gofr",
            username=STORES_USER, password=STORES_PW))
        c.add_clickhouse(clickhouse_wire.ClickhouseWire(
            endpoint=at("clickhouse")))
        c.add_elasticsearch(es_wire.ElasticsearchWire(
            endpoint=at("elasticsearch")))
        c.add_influxdb(influx_wire.InfluxWire(url=at("influxdb")))
        c.add_dgraph(dgraph_wire.DgraphWire(endpoint=at("dgraph")))

        def s3_client(secret: str = STORES_SK):
            return s3_wire.S3Wire(endpoint=at("s3"), bucket="answers",
                                  access_key=STORES_AK, secret_key=secret)
        s3 = s3_client()
        s3.use_metrics(c.metrics)
        s3.create_bucket()
        c.add_file_store(S3FileSystem("answers", engine=_S3Engine(s3)))
        c.influxdb.create_bucket("tokens")
        c.dgraph.alter("name: string @index(term) .")

        # (a) the migrations over the wires, before the app starts
        first = app.migrate(_stores_migrations())
        again = app.migrate(_stores_migrations())
        try:
            app.migrate(_stores_migrations(fail=True))
            v3_raised = False
        except RuntimeError:
            v3_raised = True
        migrated = {"first": first, "again": again, "v3_raised": v3_raised,
                    "ledgers": _stores_ledgers(c)}
        behind = mongo_wire.MongoWire(host=host, port=p["mongo"],
                                      database="gofr")
        behind.connect()
        own.append(behind)
        behind.insert_one("gofr_migrations", {"_id": "planted",
                                              "version": 3})
        planted_run = {**migrated, "ledgers": _stores_ledgers(c)}
        behind.delete_many("gofr_migrations", {"_id": "planted"})

        # the other wire clients: in their slots, GCS and Azure held here
        c.add_solr(solr_wire.SolrWire(endpoint=at("solr")))
        cb = servers["couchbase"]
        c.add_couchbase(couchbase_wire.CouchbaseWire(
            host=host, kv_port=cb.kv_port,
            query_endpoint=f"{host}:{cb.query_port}", username=STORES_USER,
            password=STORES_PW))
        c.add_scylladb(cassandra_wire.ScyllaWire(
            host=host, port=p["scylladb"], keyspace="gofr"))
        c.add_arangodb(arango_wire.ArangoWire(
            endpoint=at("arangodb"), username=STORES_USER,
            password=STORES_PW))
        c.add_surrealdb(surreal_wire.SurrealWire(
            endpoint=f"ws://{at('surrealdb')}/rpc", username=STORES_USER,
            password=STORES_PW))
        c.add_opentsdb(opentsdb_wire.OpenTSDBWire(endpoint=at("opentsdb")))

        def gcs_client(token: str = STORES_TOKEN):
            return gcs_wire.GCSWire(endpoint=at("gcs"), bucket="answers",
                                    token=token)

        def azure_client(key: str = STORES_AZ_KEY):
            return azure_blob_wire.AzureBlobWire(
                endpoint=at("azure_blob"), account="gofr", key_b64=key,
                container="answers")

        def dynamo_client(secret: str = STORES_SK):
            return dynamo_wire.DynamoKV(endpoint=at("dynamo"),
                                        table="answers",
                                        access_key=STORES_AK,
                                        secret_key=secret)
        c.add_kv_store(dynamo_client())
        held = {"gcs": gcs_client(), "azure_blob": azure_client()}
        for name, client in held.items():
            client.use_metrics(c.metrics)
            client.connect()
            c.register_health_check(name, client)

        app.post("/answer", _answer_handler(engine, tok, op_ms))
        loop, thread = _boot_app(app, "serve_stores")
        aport = app.port
        health = _http_json(aport, "GET", "/.well-known/health")
        names = ("mongo", "cassandra", "clickhouse", "elasticsearch",
                 "influxdb", "dgraph", "file", "solr", "couchbase",
                 "scylladb", "arangodb", "surrealdb", "opentsdb", "kv",
                 "gcs", "azure_blob")
        down = copy.deepcopy(health)
        down[2]["data"]["checks"]["mongo"] = mongo_wire.MongoWire(
            host=host, port=1).health_check()
        checks["a_migrations"] = (
            _stores_migrate_faults(migrated)
            + _stores_health_faults(health, names),
            _stores_migrate_faults(planted_run)
            + _stores_health_faults(down, names))
        out["a"] = {**migrated, "health": {
            k: v.get("status") for k, v in
            (health[2]["data"].get("checks") or {}).items()}}

        # (b) 16 answers gated on the 8 slots, then unary /chat gated
        prompts = _ws_prompts()
        prompts[-1] = prompts[7] + " and one more turn of it"
        bodies = [{"id": f"a{i:02d}", "user": STORES_USERS[i % 4],
                   "seq": i, "prompt": prompt, **greedy}
                  for i, prompt in enumerate(prompts)]
        ids = [b["id"] for b in bodies]

        def gated(path: str, wave: list) -> tuple:
            engine.stop()
            engine.waiting.reopen()
            base = len(made)
            got: list = [None] * len(wave)

            def call(i, body):
                got[i] = _http_json(aport, "POST", path, body)
            workers = []
            for i, body in enumerate(wave):
                workers.append(threading.Thread(target=call,
                                                args=(i, body)))
                workers[-1].start()
                deadline = time.time() + 60
                while len(made) < base + i + 1 and time.time() < deadline:
                    time.sleep(0.001)
            engine.start()
            for w in workers:
                w.join(timeout=600)
            return got, made[base:]

        for fn in counters.values():
            fn.launches = 0
        hits_before = engine.stats["prefix_hits"]
        posted, a_reqs = gated("/answer", bodies)
        launches = {name: int(fn.launches) for name, fn in counters.items()}
        prefix_hits = engine.stats["prefix_hits"] - hits_before
        unary, u_reqs = gated("/chat", [{"prompt": b["prompt"], **greedy}
                                        for b in bodies])
        answers = {b["id"]: (a[2].get("data") if a and a[0] == 201
                             else None) for b, a in zip(bodies, posted)}

        def answer_faults(got: dict, ties: dict) -> list:
            faults = []
            for i, aid in enumerate(ids):
                ans, u = got.get(aid), unary[i]
                if ans is None:
                    faults.append(f"{aid} missing")
                    continue
                if u is None or u[0] != 201 or i >= len(u_reqs) \
                        or len(u[2]["data"]["tokens"]) != WS_NEW:
                    faults.append(f"unary {aid}")
                    continue
                ref = u[2]["data"]["tokens"]
                faults += _tie_or_fault(aid, ans["tokens"], ref,
                                        u_reqs[i].prompt_tokens, judge, ties)
                if ans["tokens"] == ref and ans["digest"] != \
                        u_reqs[i].digest:
                    faults.append(f"{aid} digest")
            return faults
        ties: dict = {}
        b_faults = answer_faults(answers, ties) + (
            [] if prefix_hits >= 1 else ["no prefix hit"])
        dropped = copy.deepcopy(answers)
        del dropped[ids[2]]["tokens"][5]
        swapped = copy.deepcopy(answers)
        swapped[ids[3]]["digest"] = answers[ids[4]]["digest"]
        plants = [answer_faults(dropped, {}), answer_faults(swapped, {})]
        checks["b_answers"] = (b_faults,
                               sum(plants, []) if all(plants) else [])
        out["b"] = {"answers": sum(a is not None for a in answers.values()),
                    "prompt_tokens": [len(r.prompt_tokens) for r in a_reqs],
                    "prefix_hits": prefix_hits,
                    "slots": engine.config.max_batch,
                    "tokens_0": (answers[ids[0]] or {}).get("tokens",
                                                            [])[:8],
                    "near_ties": ties}

        # (c) read back over every wire
        back = _stores_read_back(c, s3, ids)
        ok = {aid: a for aid, a in answers.items() if a is not None}
        c_faults = _stores_read_faults(ok, back, tok.decode)
        writer = cassandra_wire.CassandraWire(
            host=host, port=p["cassandra"], keyspace="gofr",
            username=STORES_USER, password=STORES_PW)
        writer.connect()
        own.append(writer)
        behind.update_many("answers", {"_id": ids[0]},
                           {"$set": {"digest": "0" * 16}})
        writer.exec("UPDATE answers SET text = ? WHERE id = ?", "planted",
                    ids[1])
        altered = _stores_read_back(c, s3, ids[:2])
        checks["c_read_back"] = (c_faults, _stores_read_faults(
            {aid: ok[aid] for aid in ids[:2] if aid in ok}, {
                **altered, "influx_sum": float(sum(
                    len(ok[aid]["tokens"]) for aid in ids[:2]
                    if aid in ok))}, tok.decode))
        out["c"] = {"read": len(back["answers"]),
                    "influx_sum": back["influx_sum"],
                    "dgraph": {u: len(v) for u, v in back["dgraph"].items()},
                    "es_word_0": _es_word(tok.decode(
                        (ok.get(ids[0]) or {"tokens": []})["tokens"]))}

        # (d) the other wire clients
        others = {"solr": c.solr, "couchbase": c.couchbase,
                  "scylladb": c.scylladb, "arangodb": c.arangodb,
                  "surrealdb": c.surrealdb, "opentsdb": c.opentsdb,
                  "dynamo": c.kv, **held}
        first_answer = ok[ids[0]]
        kept = _keep_one(others, first_answer, tok.decode)
        wrong = {**others, "gcs": gcs_client("wrong-token"),
                 "azure_blob": azure_client(
                     "d3Jvbmcta2V5LWZvci1hbi1hY2NvdW50"),
                 "dynamo": dynamo_client("wrong-secret")}
        planted_kept = _keep_one(wrong, ok[ids[1]], tok.decode)
        checks["d_other_clients"] = (
            _keep_faults(kept, first_answer, tok.decode),
            _keep_faults(planted_kept, ok[ids[1]], tok.decode))
        out["d"] = {"kept": {k: (v if isinstance(v, dict) else
                                 type(v).__name__) for k, v in kept.items()},
                    "planted_errors": {k: v["error"] for k, v in
                                       planted_kept.items()
                                       if isinstance(v, dict)}}

        # ungated timing, unique prompts: answers / streams / streams /
        # answers
        timing: dict = {"answer": [], "chat": []}
        seq = len(bodies)
        for i, side in enumerate(("answer", "chat", "chat", "answer")):
            asks = _ws_prompts(f"t{i} ")
            base = len(made)
            runs: list = [None] * len(asks)

            def ask(j, prompt, runs=runs, side=side, i=i):
                t0 = time.perf_counter()
                if side == "answer":
                    got = _http_json(aport, "POST", "/answer", {
                        "id": f"t{i}-{j:02d}", "user": STORES_USERS[j % 4],
                        "seq": seq + 100 * i + j, "prompt": prompt,
                        **greedy})
                    runs[j] = {"status": got[0],
                               "latency_s": time.perf_counter() - t0}
                else:
                    runs[j] = _sse_call(aport, "/chat", {
                        "prompt": prompt, **greedy, "stream": True})
            askers = [threading.Thread(target=ask, args=(j, q))
                      for j, q in enumerate(asks)]
            for w in askers:
                w.start()
            for w in askers:
                w.join(timeout=600)
            if side == "answer":
                run = {"latency_s": _pcts([r["latency_s"] for r in runs
                                           if r and r["status"] == 201]),
                       "answered": sum(bool(r) and r["status"] == 201
                                       for r in runs)}
            else:
                run = _sse_timing(runs)
            run["engine_ttft_s"] = _pcts([r.ttft_ms / 1000.0
                                          for r in made[base:]
                                          if r.ttft_ms is not None])
            run["engine_decode_tokens_per_s"] = _engine_rate(made[base:])
            timing[side].append(run)

        def idle(fn, n: int = 50) -> dict:
            times = []
            for k in range(n):
                t0 = time.perf_counter()
                fn(k)
                times.append((time.perf_counter() - t0) * 1000.0)
            return _pcts(times)
        idle_ms = {
            "mongo": {"write": idle(lambda k: c.mongo.insert_one(
                "idle", {"_id": f"i{k}", "v": k})),
                "read": idle(lambda k: c.mongo.find_one(
                    "idle", {"_id": f"i{k}"}))},
            "cassandra": {"write": idle(lambda k: c.cassandra.exec(
                "INSERT INTO answers (id, user) VALUES (?, ?)", f"i{k}",
                "idle")), "read": idle(lambda k: c.cassandra.query(
                    "SELECT id FROM answers WHERE id = ?", f"i{k}"))},
            "clickhouse": {"write": idle(lambda k: c.clickhouse.exec(
                "INSERT INTO answers VALUES (?, ?, ?, ?)", f"i{k}", 0, 0,
                "")), "read": idle(lambda k: c.clickhouse.select(
                    "SELECT id FROM answers WHERE id = ?", f"i{k}"))},
            "elasticsearch": {"write": idle(lambda k: c.elasticsearch.index(
                "idle", f"i{k}", {"text": "idle"})),
                "read": idle(lambda k: c.elasticsearch.get("idle",
                                                           f"i{k}"))},
            "s3": {"write": idle(lambda k: c.file.create(f"idle/{k}",
                                                         b"x")),
                   "read": idle(lambda k: c.file.read(f"idle/{k}"))},
            "influxdb": {"write": idle(lambda k: c.influxdb.write_point(
                "tokens", "idle", float(k), {"n": 1.0})),
                "read": idle(lambda k: c.influxdb.query(
                    "tokens", "idle", "n", start=float(k)))},
            "dgraph": {"write": idle(lambda k: c.dgraph.mutate(
                {"name": f"idle-{k}"})), "read": idle(
                lambda k: c.dgraph.query({"name": f"idle-{k}"}))}}
        metrics = c.metrics
        stats_names = {"mongo": "app_mongo_stats",
                       "cassandra": "app_cassandra_stats",
                       "clickhouse": "app_clickhouse_stats",
                       "elasticsearch": "app_elasticsearch_stats",
                       "s3": "app_s3_stats", "file": "app_file_stats",
                       "influxdb": "app_influxdb_stats",
                       "dgraph": "app_dgraph_stats",
                       "solr": "app_solr_stats",
                       "couchbase": "app_couchbase_stats",
                       "scylladb": "app_scylladb_stats",
                       "arangodb": "app_arangodb_stats",
                       "surrealdb": "app_surrealdb_stats",
                       "opentsdb": "app_opentsdb_stats",
                       "gcs": "app_gcs_stats",
                       "azure_blob": "app_azure_blob_stats",
                       "dynamo": "app_kv_stats"}
        out["timing"] = {
            **timing, "card": smi_line,
            "store_write_ms_under_load": {k: _pcts(v)
                                          for k, v in op_ms.items()},
            "store_ms_idle": idle_ms,
            "stats_p50_ms": {k: _hist_p50_ms(metrics, v)
                             for k, v in stats_names.items()},
            "definition": "16 /answer requests (16 /chat streams) at "
            "once on 8 slots, 64 tokens each, prompts 21-1501 tokens; an "
            "answer's latency from the send to its reply, after its "
            "seven store writes; store times are the handler's own wall "
            "time of each call (under load: the (b) wave and the two "
            "/answer timing waves) and 50 calls of each with no traffic"}

        # (e) the kernels of the wave, then the stop
        checks["e_launches_stop"] = (
            _launch_faults(launches),
            _launch_faults(dict.fromkeys(launches, 0)))
        out["launches"] = launches
        for client in own:
            client.close()
        ports = {name: _server_ports(s) for name, s in servers.items()}

        def open_now() -> dict:
            return {name: sum(_open_connections(q) for q in qs)
                    for name, qs in ports.items()}
        open_before = open_now()
        _stop_app(app, loop, thread)
        loop = None
        t_stop = time.perf_counter()
        while any(open_now().values()) and \
                time.perf_counter() - t_stop < 2.0:
            time.sleep(0.01)
        stopped = {"open": open_now(), "engine_running": engine._running}
        checks["e_launches_stop"] = (
            checks["e_launches_stop"][0] + _wire_stop_faults(stopped),
            checks["e_launches_stop"][1] + _wire_stop_faults(
                {**stopped, "open": open_before}))
        out["e"] = {**stopped, "open_before": open_before,
                    "stop_s": time.perf_counter() - t_stop}
        out["near_tie_judge_s"] = judge.seconds()
    finally:
        engine.submit = inner_submit
        for client in own:
            client.close()
        if loop is not None and loop.is_running():
            _stop_app(app, loop, thread)
        for server in started:
            server.close()
        judge.release()
    del app, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_stores: failed checks {failed}, "
                             f"planted faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out["launches"]



# ---------------------------------------------------------------- CLI
CLI_NEW = 32
CLI_GEN_RUNS = 5
CLI_SUBCOMMANDS = ("generate", "batch", "answers get", "answers rm")


def _cli_prompts(generate_prompt: str) -> list:
    """``batch``'s eight prompts (21-1501 byte tokens): six of
    ``_app_prompts``' (fresh, tag ``cli``), its 1501-token one (wider
    than the 1024 bucket: it walks through the chunk kernel), and
    ``generate_prompt`` extended (a prefix hit on the pages ``generate``
    left in the cache)."""
    fresh = _app_prompts("cli ")
    return ([fresh[i] for i in (0, 2, 3, 4, 5, 7)] + [fresh[8]]
            + [generate_prompt + " and one more question about it"])


def _cli_wait(req, timeout_s: float = 600.0):
    if not req.done.wait(timeout_s):
        raise TimeoutError(f"no answer within {timeout_s} s")
    if req.error is not None:
        raise RuntimeError(req.error)
    return req


def _cli_answer(aid: str, req, tok) -> dict:
    from gofr_tpu_torch.serving.integrity import request_digest
    return {"id": aid, "tokens": list(req.generated),
            "text": tok.decode(req.generated),
            "request_digest": request_digest(req.prompt_tokens, req.params,
                                             req.generated),
            "prompt_tokens": len(req.prompt_tokens), "ttft_ms": req.ttft_ms}


def _cli_keep(ctx, answer: dict) -> None:
    """Keep an answer's text over FTP (``answer-<id>.txt``) and in the
    NATS-KV bucket (key ``<id>``)."""
    ctx.file.create(f"answer-{answer['id']}.txt", answer["text"])
    ctx.kv.set(answer["id"], answer["text"])


def _cli_register(app, tok, prompts=None, made=None) -> None:
    """The CLI's subcommands, as a user writes them: the engine from
    ``ctx.model("llama")``, the stores from ``ctx.file`` and ``ctx.kv``.
    ``prompts`` are ``batch``'s; ``made`` collects every request the
    handlers submit."""
    from gofr_tpu_torch.serving.engine import SamplingParams
    made = made if made is not None else []

    def params(ctx):
        return SamplingParams(temperature=0.0, max_new_tokens=int(
            ctx.param("max_tokens") or CLI_NEW))

    @app.sub_command("generate", description="answer one prompt",
                     help="--prompt=<text> --max_tokens=<n> --id=<id>")
    def generate(ctx):
        engine = ctx.model("llama")
        made.append(engine.submit(tok.encode(ctx.param("prompt")),
                                  params(ctx)))
        answer = _cli_answer(ctx.param("id") or "g", _cli_wait(made[-1]),
                             tok)
        _cli_keep(ctx, answer)
        return answer

    @app.sub_command("batch", description="answer n prompts together",
                     help="--n=<count> --max_tokens=<n>")
    def batch(ctx):
        engine = ctx.model("llama")
        n = int(ctx.param("n") or len(prompts))
        reqs = [engine.submit(tok.encode(p), params(ctx))
                for p in prompts[:n]]
        made.extend(reqs)
        answers = [_cli_answer(f"b{i}", _cli_wait(r), tok)
                   for i, r in enumerate(reqs)]
        for answer in answers:
            _cli_keep(ctx, answer)
        return {"answers": answers}

    @app.sub_command("answers get", description="read a kept answer back",
                     help="--id=<id>")
    def answers_get(ctx):
        aid = ctx.param("id")
        return {"id": aid, "ftp": ctx.file.read_text(f"answer-{aid}.txt"),
                "kv": ctx.kv.get(aid)}

    @app.sub_command("answers rm", description="remove a kept answer",
                     help="--id=<id>")
    def answers_rm(ctx):
        aid = ctx.param("id")
        ctx.file.remove(f"answer-{aid}.txt")
        ctx.kv.delete(aid)
        return {"removed": aid}


def _cli_run(app, argv: list) -> tuple:
    """(exit code, stdout, stderr) of one ``CMDApp.run``."""
    import io
    from gofr_tpu_torch.cli import Out
    out, err = io.StringIO(), io.StringIO()
    app.out = Out(stream=out, force_tty=False)
    app.err_out = Out(stream=err, force_tty=False)
    code = app.run(argv)
    return code, out.getvalue(), err.getvalue()


def _cli_help_app():
    """The CLI with its subcommands and no model or store (the help
    subprocess builds it)."""
    from gofr_tpu_torch.app import new_cmd
    from gofr_tpu_torch.config import DictConfig
    app = new_cmd(config=DictConfig({"APP_NAME": "serve-cli"}))
    _cli_register(app, None)
    return app


def _cli_help_faults(runs: dict) -> list:
    """``help`` / ``-h`` exit 0 listing every subcommand; an unknown
    subcommand exits 2."""
    faults = []
    for label, (code, out, _err) in runs.items():
        want = 2 if label.startswith("unknown") else 0
        if code != want:
            faults.append(f"{label} exit {code}")
        if not all(s in out for s in CLI_SUBCOMMANDS):
            faults.append(f"{label} lists {out!r}")
    return faults


def _cli_read_faults(answers: dict, back: dict) -> list:
    """Each answer's text read back over FTP and NATS-KV as printed."""
    faults = []
    for aid, answer in answers.items():
        got = back.get(aid)
        if got is None or got[0] != 0:
            faults.append(f"{aid} not read back")
            continue
        doc = json.loads(got[1])
        for store in ("ftp", "kv"):
            if doc.get(store) != answer["text"]:
                faults.append(f"{aid} {store}")
    return faults


def phase_serve_cli(dev, smi_line: str, cfg=None) -> dict:
    """The CLI on the card: ``new_cmd`` (``cli/cmd.CMDApp``) with
    ``llama3_1b`` (full width and depth, random bf16 weights from seed 0,
    ``serve_config``: 8 slots, prefix cache on; ``cfg`` another config)
    registered by ``add_model("llama", ...)``, an ``FTPFileSystem`` on
    the port's ``MiniFTPServer`` by ``add_file_store`` and a ``NATSKV``
    on its ``MiniJetStreamServer`` by ``add_kv_store``, both on loopback.
    The subcommands are the user's (``_cli_register``): ``generate``,
    ``batch``, ``answers get``, ``answers rm``. Greedy. Checks, each also
    shown a planted fault it must reject:

    (a) ``generate --prompt= --max_tokens=32`` exits 0 (five runs of one
        prompt); its printed tokens and ``request_digest`` equal the
        engine's answer to the same prompt submitted directly, or first
        differ at a near tie (``_near_tie_judge``); planted: a token
        changed.
    (b) ``batch --n=8``: eight prompts of 21-1501 tokens in flight
        together on the 8 slots, one walked in chunks, one a prefix hit
        on ``generate``'s pages: each answer equals its single run
        (submitted alone afterwards), or parts at a near tie; planted:
        answers swapped between ids.
    (c) every answer reads back over FTP and NATS-KV (``answers get``)
        as printed; after ``answers rm`` an ``answers get`` exits 1 with
        ``error:`` on stderr; planted: one stored byte changed over FTP
        behind the app.
    (d) ``help`` and ``-h`` exit 0 and list every subcommand, an unknown
        subcommand exits 2: in process, and ``help`` once through a
        subprocess with a real ``sys.argv`` (no model loaded); planted:
        an exit code flipped.
    (e) the launch counters of the flash, paged decode, paged chunk and
        ``rope_kv_write`` wrappers, zeroed before ``batch`` and read
        after it, all rise; planted: the same over a subcommand that
        answers a canned string and never touches the engine.

    Also: ``generate``'s wall p50 over its five runs and the engine's
    TTFT p50; ``batch``'s decode tokens/s; FTP write / read and NATS-KV
    set / get p50, idle and while ``batch`` runs."""
    import copy
    import torch
    from gofr_tpu_torch.app import new_cmd
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.datasource.ftp import FTPFileSystem, MiniFTPServer
    from gofr_tpu_torch.datasource.nats_kv import NATSKV
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write
    from gofr_tpu_torch.pubsub.jetstream import MiniJetStreamServer
    from gofr_tpu_torch.serving.app import build_engine
    from gofr_tpu_torch.serving.engine import SamplingParams
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "rope_kv_write": rope_kv_write}
    checks: dict = {}
    out: dict = {"phase": "serve_cli", "card": smi_line}
    cfg = cfg or LlamaConfig.llama3_1b()
    engine = build_engine(cfg, device=dev)
    tok = _PrintableTokenizer()
    judge = _near_tie_judge(engine.params, cfg)
    ftp_server = MiniFTPServer()
    ftp_server.start()
    brokers = _LoopThread()
    js = MiniJetStreamServer()
    brokers.run(js.start())
    own: list = []
    app = None
    try:
        app = new_cmd(config=DictConfig({"APP_NAME": "serve-cli"}))
        c = app.container
        c.add_model("llama", engine)
        c.add_file_store(FTPFileSystem(port=ftp_server.port))
        c.add_kv_store(NATSKV(port=js.port, bucket="answers"))
        gen_prompt = _app_prompts("gen ")[6]
        prompts = _cli_prompts(gen_prompt)
        made: list = []
        _cli_register(app, tok, prompts, made)
        engine.start()

        # (a) generate, five runs, then the same prompt submitted directly
        gen_runs, gen_wall = [], []
        for i in range(CLI_GEN_RUNS):
            t0 = time.perf_counter()
            code, text, err = _cli_run(app, [
                "generate", f"--prompt={gen_prompt}",
                f"--max_tokens={CLI_NEW}", f"--id=g{i}"])
            gen_wall.append(time.perf_counter() - t0)
            gen_runs.append((code, json.loads(text) if code == 0 else None,
                             err))
        direct = _cli_answer("direct", _cli_wait(engine.submit(
            tok.encode(gen_prompt), SamplingParams(
                temperature=0.0, max_new_tokens=CLI_NEW))), tok)
        ties: dict = {}

        def generate_faults(runs: list) -> list:
            faults = []
            for i, (code, doc, err) in enumerate(runs):
                if code != 0 or doc is None:
                    faults.append(f"generate {i} exit {code} {err!r}")
                    continue
                faults += _tie_or_fault(
                    f"g{i}", doc["tokens"], direct["tokens"],
                    tok.encode(gen_prompt), judge, ties)
                if doc["tokens"] == direct["tokens"] and \
                        doc["request_digest"] != direct["request_digest"]:
                    faults.append(f"g{i} digest")
                if len(doc["tokens"]) != CLI_NEW:
                    faults.append(f"g{i} {len(doc['tokens'])} tokens")
            return faults
        changed = copy.deepcopy(gen_runs)
        changed[-1][1]["tokens"][3] = (changed[-1][1]["tokens"][3] + 1) \
            % cfg.vocab_size
        checks["a_generate"] = (generate_faults(gen_runs),
                                generate_faults(changed))
        out["a"] = {"exit_codes": [r[0] for r in gen_runs],
                    "tokens_0": direct["tokens"][:8],
                    "digest": direct["request_digest"],
                    "prompt_tokens": direct["prompt_tokens"],
                    "near_ties": dict(ties)}

        # (b) batch: eight in flight together, the stores timed meanwhile
        load_ms: dict = {"ftp_write": [], "ftp_read": [], "kv_set": [],
                         "kv_get": []}
        running = threading.Event()
        running.set()

        def store_load():
            k = 0
            while running.is_set():
                for name, call in (
                        ("ftp_write", lambda: c.file.create(
                            f"load-{k % 8}.txt", "x" * 64)),
                        ("ftp_read", lambda: c.file.read(
                            f"load-{k % 8}.txt")),
                        ("kv_set", lambda: c.kv.set(f"load{k % 8}",
                                                    "x" * 64)),
                        ("kv_get", lambda: c.kv.get(f"load{k % 8}"))):
                    t0 = time.perf_counter()
                    call()
                    load_ms[name].append(
                        (time.perf_counter() - t0) * 1000.0)
                k += 1
        for fn in counters.values():
            fn.launches = 0
        hits_before = engine.stats["prefix_hits"]
        base = len(made)
        loader = threading.Thread(target=store_load, daemon=True)
        loader.start()
        code, text, err = _cli_run(app, ["batch", "--n=8",
                                         f"--max_tokens={CLI_NEW}"])
        running.clear()
        loader.join(timeout=60)
        launches = {name: int(fn.launches) for name, fn in counters.items()}
        b_reqs = made[base:]
        prefix_hits = engine.stats["prefix_hits"] - hits_before
        batch = json.loads(text)["answers"] if code == 0 else []
        singles = [_cli_answer(f"s{i}", _cli_wait(engine.submit(
            tok.encode(p), SamplingParams(temperature=0.0,
                                          max_new_tokens=CLI_NEW))), tok)
                   for i, p in enumerate(prompts)]
        b_ties: dict = {}

        def batch_faults(answers: list) -> list:
            if code != 0 or len(answers) != len(prompts):
                return [f"batch exit {code} {err!r}"]
            faults = []
            for i, (answer, single) in enumerate(zip(answers, singles)):
                if answer["id"] != f"b{i}":
                    faults.append(f"b{i} id {answer['id']}")
                faults += _tie_or_fault(f"b{i}", answer["tokens"],
                                        single["tokens"],
                                        tok.encode(prompts[i]), judge,
                                        b_ties)
            return faults + ([] if prefix_hits >= 1 else ["no prefix hit"])
        swapped = copy.deepcopy(batch)
        if len(swapped) > 2:
            swapped[1]["tokens"], swapped[2]["tokens"] = \
                swapped[2]["tokens"], swapped[1]["tokens"]
        checks["b_batch"] = (batch_faults(batch), batch_faults(swapped))
        out["b"] = {"exit_code": code,
                    "prompt_tokens": [len(r.prompt_tokens) for r in b_reqs],
                    "prefix_hits": prefix_hits,
                    "prefill_calls": engine.stats.get("prefill_calls"),
                    "near_ties": dict(b_ties)}

        # (c) every answer read back over both wires, then removed
        printed = {a["id"]: a for a in batch}
        printed.update({f"g{i}": r[1] for i, r in enumerate(gen_runs)
                        if r[1] is not None})
        back = {aid: _cli_run(app, ["answers", "get", f"--id={aid}"])
                for aid in printed}
        behind = FTPFileSystem(port=ftp_server.port)
        behind.connect()
        own.append(behind)
        victim = "b0"
        text0 = printed[victim]["text"]
        behind.create(f"answer-{victim}.txt",
                      chr(33 + (ord(text0[0]) - 32) % 94) + text0[1:])
        altered = {victim: _cli_run(app, ["answers", "get",
                                          f"--id={victim}"])}
        behind.create(f"answer-{victim}.txt", text0)
        rm = _cli_run(app, ["answers", "rm", "--id=g0"])
        gone = _cli_run(app, ["answers", "get", "--id=g0"])

        def rm_faults(rm, gone) -> list:
            faults = [] if rm[0] == 0 else [f"rm exit {rm[0]}"]
            if gone[0] != 1 or "error:" not in gone[2]:
                faults.append(f"get after rm: exit {gone[0]} {gone[2]!r}")
            return faults
        checks["c_read_back"] = (
            _cli_read_faults(printed, back) + rm_faults(rm, gone),
            _cli_read_faults({victim: printed[victim]}, altered))
        out["c"] = {"read_back": sum(v[0] == 0 for v in back.values()),
                    "answers": len(printed), "rm_exit": rm[0],
                    "get_after_rm": [gone[0], gone[2].strip()[:120]]}

        # (d) help, -h, an unknown subcommand; help in a subprocess
        helps = {"help": _cli_run(app, ["help"]),
                 "-h": _cli_run(app, ["-h"]),
                 "unknown": _cli_run(app, ["no-such-command"])}
        script = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
                  "import chip_smoke; "
                  "sys.exit(chip_smoke._cli_help_app().run())")
        proc = subprocess.run([sys.executable, "-c", script, str(ROOT),
                               "help"], capture_output=True, text=True,
                              timeout=300)
        helps["help (subprocess)"] = (proc.returncode, proc.stdout,
                                      proc.stderr)
        flipped = dict(helps)
        flipped["-h"] = (2,) + helps["-h"][1:]
        checks["d_help"] = (_cli_help_faults(helps),
                            _cli_help_faults(flipped))
        out["d"] = {k: v[0] for k, v in helps.items()}

        # (e) the kernels of the batch; a canned handler touches none
        @app.sub_command("canned", description="a canned answer")
        def canned(ctx):
            return {"answers": [{"id": "b0", "text": "canned"}]}
        for fn in counters.values():
            fn.launches = 0
        _cli_run(app, ["canned"])
        canned_launches = {name: int(fn.launches)
                           for name, fn in counters.items()}
        checks["e_launches"] = (_launch_faults(launches),
                                _launch_faults(canned_launches))
        out["launches"] = launches

        def idle(fn, n: int = 30) -> dict:
            times = []
            for k in range(n):
                t0 = time.perf_counter()
                fn(k)
                times.append((time.perf_counter() - t0) * 1000.0)
            return _pcts(times)
        out["timing"] = {
            "card": smi_line,
            "generate_wall_s": _pcts(gen_wall),
            "generate_engine_ttft_s": _pcts([
                r[1]["ttft_ms"] / 1000.0 for r in gen_runs
                if r[1] is not None and r[1]["ttft_ms"] is not None]),
            "batch_decode_tokens_per_s": _engine_rate(b_reqs),
            "batch_engine_ttft_s": _pcts([r.ttft_ms / 1000.0 for r in b_reqs
                                          if r.ttft_ms is not None]),
            "store_ms_during_batch": {k: _pcts(v)
                                      for k, v in load_ms.items()},
            "store_ops_during_batch": {k: len(v)
                                       for k, v in load_ms.items()},
            "store_ms_idle": {
                "ftp_write": idle(lambda k: c.file.create(
                    f"idle-{k}.txt", "x" * 64)),
                "ftp_read": idle(lambda k: c.file.read(f"idle-{k}.txt")),
                "kv_set": idle(lambda k: c.kv.set(f"idle{k}", "x" * 64)),
                "kv_get": idle(lambda k: c.kv.get(f"idle{k}"))},
            "definition": f"generate: {CLI_GEN_RUNS} runs of one "
            f"{direct['prompt_tokens']}-token prompt, {CLI_NEW} tokens, "
            "wall of CMDApp.run; batch: 8 prompts of 21-1501 tokens in "
            "flight on 8 slots; store times: one call's wall time, 30 "
            "calls of each idle, and a thread calling them in turn "
            "while batch runs"}
        out["near_tie_judge_s"] = judge.seconds()
    finally:
        engine.stop()
        for client in own:
            client.close()
        if app is not None:
            for store in (app.container.file, app.container.kv):
                close = getattr(store, "close", None)
                if close is not None:
                    close()
        ftp_server.close()
        brokers.run(js.close())
        brokers.close()
        judge.release()
    del app, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_cli: failed checks {failed}, "
                             f"planted faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out["launches"]


# ---------------------------------------------------------- the examples
EX_NEW = 32
#: (e)'s concurrency ladder and SLO: ``scripts/torch_capacity.py``'s
#: defaults (TTFT 2 s, TPOT 0.5 s, end to end 30 s, availability 0.999)
EX_LEVELS = (1, 2, 4, 8)
EX_SLO = {"ttft_s": 2.0, "tpot_s": 0.5, "e2e_s": 30.0, "availability": 0.999}
#: (g)'s utterances: seconds each, published to the worker together
EX_UTTERANCES = (1.0, 2.5, 4.0, 5.0)
#: the surfaces a host that leads no fleet does not serve
EX_FLEET = ("fleet", "fleet_events", "fleet_incidents")


def _ex_module(path: Path, name: str):
    """The file at ``path`` as a module of its own, ``name``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ex_app(example: str, dev, **keys):
    """``examples_torch/<example>``'s ``build_app`` with ``keys`` over
    the app's own (loopback, free ports), on ``dev``."""
    from gofr_tpu_torch.config import DictConfig
    mod = _ex_module(ROOT / "examples_torch" / example / "main.py",
                     "smoke_example_" + example.replace("-", "_"))
    return mod.build_app(DictConfig({
        "HTTP_HOST": "127.0.0.1", "HTTP_PORT": "0", "METRICS_PORT": "0",
        "APP_NAME": "serve-examples", **keys}), device=dev)


def _ex_prompts() -> list:
    """(a)'s eight ``/chat`` prompts in the order they are sent (21 to
    1501 byte tokens): four that take the four slots at once (611, the
    1501-token walk, 901 and 21 tokens), two that repeat the first 600
    and 700 characters of the 611- and 901-token ones (prefix hits on the
    pages those pinned when they retired), and two fresh ones."""
    fresh = _app_prompts("ex ")
    return [fresh[6], fresh[8], fresh[7], fresh[0],
            fresh[6][:600] + " and one more question about the pages",
            fresh[7][:700] + " and what the cache keeps of it",
            fresh[3], fresh[4]]


def _ex_dequantized(params: dict) -> dict:
    """A quantized Llama tree (``ops/quant.quantize_llama_*``: ``[N, K]``
    codes, per-output scales) as float32 weights in the model's own
    layout."""
    from gofr_tpu_torch.ops.quant import codes_of, is_quantized

    def deq(w):
        return codes_of(w).float() * w["s"].float() if is_quantized(w) \
            else w.float()
    out = {"final_norm": params["final_norm"].float(),
           "embed": deq(params["embed"]),
           "layers": {name: deq(w) if name.endswith("_norm")
                      else deq(w).transpose(1, 2).contiguous()
                      for name, w in params["layers"].items()}}
    if "lm_head" in params:
        out["lm_head"] = deq(params["lm_head"]).t().contiguous()
    return out


def _ex_made(engine) -> list:
    """The requests ``engine`` is given from here on, in order."""
    made, inner = [], engine.submit

    def submit(*args, **kwargs):
        made.append(inner(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    return made


def _ex_in_order(port: int, asks: list, made: list) -> list:
    """``asks`` ((path, body, stream) each) sent from threads, each once
    the one before it reached the engine, so ``made`` holds them in order;
    the answers once all are in."""
    got: list = [None] * len(asks)

    def call(i, path, body, stream):
        got[i] = (_sse_call(port, path, body) if stream
                  else _http_json(port, "POST", path, body))

    workers = []
    for i, ask in enumerate(asks):
        base = len(made)
        workers.append(threading.Thread(target=call, args=(i, *ask)))
        workers[-1].start()
        deadline = time.time() + 60
        while len(made) <= base and time.time() < deadline:
            time.sleep(0.001)
    for w in workers:
        w.join(timeout=600)
    return got


def _ex_singles(engine, reqs: list) -> list:
    """Each request's prompt submitted alone, greedy, ``EX_NEW`` tokens:
    its tokens."""
    from gofr_tpu_torch.serving.engine import SamplingParams
    out = []
    for r in reqs:
        single = engine.submit(list(r.prompt_tokens), SamplingParams(
            temperature=0.0, max_new_tokens=EX_NEW))
        out.append(list(_cli_wait(single).generated))
    return out


def _ex_answer_faults(answers: list, reqs: list) -> list:
    """Every answer served: ``/chat`` 201 with its request's tokens, a
    ``/v1/completions`` 201, a stream 200 ending in ``[DONE]``."""
    faults = []
    for i, (a, r) in enumerate(zip(answers, reqs)):
        if isinstance(a, dict):
            events = [e for _, e in a["events"]]
            if a["status"] != 200 or not events or events[-1] != "[DONE]":
                faults.append(f"stream {i}: {a['status']}")
        elif a[0] != 201:
            faults.append(f"answer {i}: {a[0]}")
        elif "data" in a[2] and a[2]["data"].get("tokens") \
                != list(r.generated):
            faults.append(f"answer {i}: not its request's tokens")
        elif "data" not in a[2] and not a[2].get("choices"):
            faults.append(f"answer {i}: no choices")
    return faults + ([] if len(answers) == len(reqs)
                     else [f"{len(reqs)} requests, {len(answers)} answers"])


def _ex_token_faults(label: str, tokens: list, singles: list, reqs: list,
                     judge, ties: dict) -> list:
    """Each request's tokens equal its single run's, or part at a near
    tie."""
    faults = []
    for i, (got, want, r) in enumerate(zip(tokens, singles, reqs)):
        faults += _tie_or_fault(f"{label}{i}", got, want,
                                list(r.prompt_tokens), judge, ties)
    return faults


def _ex_bundle_faults(code: int, bundle: dict, surfaces: tuple,
                      prompts: list) -> list:
    """``bundle.py`` exits 0; every surface but the fleet's present,
    ``errors`` naming only those; its workload holds ``prompts``."""
    from gofr_tpu_torch.serving.replay import parse_workload
    faults = [] if code == 0 else [f"exit {code}"]
    missing = [key for key, *_ in surfaces
               if key not in EX_FLEET and bundle.get(key) is None]
    if missing:
        faults.append(f"missing {missing}")
    if sorted(bundle.get("errors") or {}) != sorted(EX_FLEET):
        faults.append(f"errors {sorted(bundle.get('errors') or {})}")
    records = parse_workload(bundle["workload"])["records"] \
        if bundle.get("workload") else []
    if sorted(r.get("prompt_tokens") or [] for r in records) \
            != sorted(prompts):
        faults.append(f"workload holds {len(records)} records")
    return faults


def _ex_replay_faults(records: list, reqs: list, judge, ties: dict) -> list:
    """Each replayed request's tokens equal its recorded completion's, or
    part at a near tie."""
    faults = [] if len(reqs) == len(records) else [
        f"{len(reqs)} replayed of {len(records)}"]
    for i, (rec, req) in enumerate(zip(records, reqs)):
        faults += _tie_or_fault(f"replay{i}", list(req.generated),
                                list(rec.get("completion_tokens") or []),
                                list(rec["prompt_tokens"]), judge, ties)
    return faults


def _ex_capacity_faults(levels: list, result: dict, setpoint: int,
                        pick) -> list:
    """Every level answered (qps > 0, goodput in (0, 1]); level 4 beats
    level 1; the sweep's max sustainable level is ``pick``'s over the
    curve and the router's setpoint."""
    faults = []
    for e in levels:
        g = e.get("goodput_ratio")
        if not e.get("qps") or g is None or not 0.0 < g <= 1.0:
            faults.append(f"level {e['concurrency']}: qps {e.get('qps')} "
                          f"goodput {g}")
    qps = {e["concurrency"]: e["qps"] for e in levels}
    if not qps.get(4, 0) > qps.get(1, float("inf")):
        faults.append(f"qps at 4 {qps.get(4)} vs at 1 {qps.get(1)}")
    best = pick(levels)
    best = best["concurrency"] if best else 0
    if not best == result["max_sustainable_concurrency"] == setpoint:
        faults.append(f"curve picks {best}, the sweep "
                      f"{result['max_sustainable_concurrency']}, the "
                      f"router {setpoint}")
    return faults


def _ex_tool_faults(good: tuple, bad: tuple) -> list:
    """``torch_replay.py`` exits 0 on its capture and 2, saying so, on
    the capture with a token changed."""
    faults = [] if good[0] == 0 else [f"capture: exit {good[0]} "
                                      f"{good[1][-300:]!r}"]
    if bad[0] != 2 or "# DIVERGED" not in bad[1]:
        faults.append(f"changed: exit {bad[0]}")
    return faults


def _ex_changed(text: str, at: int = 3) -> str:
    """A workload JSONL with the first record's token ``at`` changed."""
    lines = text.splitlines()
    rec = json.loads(lines[1])
    toks = rec["completion_tokens"]
    toks[at] = (toks[at] + 1) % 256
    lines[1] = json.dumps(rec)
    return "\n".join(lines) + "\n"


def phase_serve_examples(dev, smi_line: str) -> dict:
    """The apps of ``examples_torch/`` and the operator tools on the
    card. The ``model-serving`` example's own ``build_app`` (its config
    keys, ``EngineConfig(max_batch=4, max_seq=8192)``, ``serve_model`` +
    ``install_openai_routes``) with ``MODEL_PRESET=llama3_1b`` (full
    width and depth, random bf16 weights from seed 0), booted as a user
    boots it; the ``asr-worker`` example's with ``whisper_large_v3``. The
    four apps' weights are made together on worker threads as the phase
    starts. Greedy throughout. Checks, each also shown a planted fault it
    must reject:

    (a) after ``POST /debug/workload/start``, 8 ``/chat`` requests (21 to
        1501 tokens, ``_ex_prompts``: one walked, two prefix hits) in
        flight on the 4 slots, then 2 ``/v1/completions`` and a streamed
        ``/v1/chat/completions``, 32 new tokens each: every answer
        served and every request's tokens equal to its single run
        (submitted alone afterwards) or parting at a near tie
        (``_near_tie_judge``); health UP naming the engine and the card;
        planted: two answers swapped.
    (b) the same 8 ``/chat`` requests on the example with
        ``MODEL_QUANT=int8`` against that engine's single runs; planted:
        as in (a).
    (c) ``python scripts/bundle.py`` against (a)'s app as a subprocess:
        exit 0, every surface a host without a fleet serves present,
        ``errors`` only the fleet's, the workload (a)'s 11 requests;
        planted: a surface nulled.
    (d) the bundle's workload replayed (``replay_workload``,
        ``closed_loop=4``) on a fresh engine of the example, same preset
        and seed: each request's tokens equal its recorded ones or part
        at a near tie; planted: a recorded token changed.
    (e) ``scripts/torch_capacity.py``'s ``sweep`` over that workload on
        that engine at levels 1, 2, 4, 8 with the tool's default SLO:
        qps > 0 and goodput in (0, 1] at every level, level 4's qps over
        level 1's, the setpoint file read by ``RouterConfig
        (setpoint_file=)`` giving the router the sweep's max sustainable
        concurrency; planted: the curve with level 2 tripped (1).
    (f) a workload captured from the demo engine on the card
        (``demo_llama_engine(workload_capture=True)``, one request at a
        time): ``python scripts/torch_replay.py <file> --closed-loop 1``
        exits 0, and 2 on the file with a token changed; planted: the
        changed file's exit in place of the capture's.
    (g) 4 utterances of 1-5 s published to the ``asr-worker`` example's
        worker and one ``POST /transcribe``: every answer's tokens read
        back through the teacher-forced decoder (``_readback_faults``);
        planted: a token changed.
    (h) the launch counters of the flash, paged decode, paged chunk and
        ``rope_kv_write`` wrappers over (a)'s requests and over (b)'s,
        ``wq_gemm``'s over (b)'s: all rise; planted: the same counters
        over routes that never touch the engine.

    Also: ``/chat`` TTFT p50 / p99 and decode tokens/s in (a) and (b),
    the replay's wall and qps, the capacity curve and its setpoint, the
    bundle's seconds and bytes, the worker's utterances/s."""
    import asyncio
    import copy
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops import audio
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write
    from gofr_tpu_torch.ops.quant import wq_gemm
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    from gofr_tpu_torch.serving.observability import SLOConfig
    from gofr_tpu_torch.serving.replay import parse_workload, replay_workload
    from gofr_tpu_torch.serving.router import FleetRouter, RouterConfig
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    gpu = torch.cuda.get_device_name(0) if cuda else "cpu"
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "rope_kv_write": rope_kv_write}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        wq_gemm.launches = 0

    def read(wq: bool = False) -> dict:
        got = {name: int(fn.launches) for name, fn in counters.items()}
        return {**got, "wq_gemm": int(wq_gemm.launches)} if wq else got

    capacity = _ex_module(ROOT / "scripts" / "torch_capacity.py",
                          "smoke_torch_capacity")
    bundle_mod = _ex_module(ROOT / "scripts" / "bundle.py", "smoke_bundle")
    checks: dict = {}
    out: dict = {"phase": "serve_examples", "card": smi_line}
    tmp = Path(tempfile.mkdtemp(prefix="serve_examples_"))
    llama = {"MODEL_PRESET": "llama3_1b"}
    # the four apps' random weights are drawn on the CPU (the examples'
    # torch.Generator), one thread each
    pool = ThreadPoolExecutor(max_workers=4)
    t0 = time.perf_counter()
    pending = {
        "a": pool.submit(_ex_app, "model-serving", dev, **llama),
        "b": pool.submit(_ex_app, "model-serving", dev, MODEL_QUANT="int8",
                         **llama),
        "d": pool.submit(_ex_app, "model-serving", dev, **llama),
        "g": pool.submit(_ex_app, "asr-worker", dev,
                         MODEL_PRESET="whisper_large_v3")}
    apps: dict = {}
    booted: dict = {}
    judges: list = []
    procs: list = []
    try:
        apps = {k: f.result() for k, f in pending.items()}
        out["apps_built_s"] = time.perf_counter() - t0
        cfg = LlamaConfig.llama3_1b()
        engines = {k: apps[k].container.get_model("llama")
                   for k in ("a", "b", "d")}
        made = {k: _ex_made(e) for k, e in engines.items()}
        for k in ("a", "b", "g"):
            booted[k] = _boot_app(apps[k], f"serve_examples ({k})")
        port = apps["a"].port

        # (a) the wave, captured
        start = _http_json(port, "POST", "/debug/workload/start", {})
        prompts = _ex_prompts()
        chat = [("/chat", {"prompt": p, "max_tokens": EX_NEW,
                           "temperature": 0}, False) for p in prompts]
        v1 = [("/v1/completions", {"model": "llama3_1b", "prompt": p,
                                   "max_tokens": EX_NEW, "temperature": 0},
               False) for p in _app_prompts("v1 ")[1:3]] + [
            ("/v1/chat/completions", {
                "model": "llama3_1b", "max_tokens": EX_NEW,
                "temperature": 0, "stream": True,
                "messages": [{"role": "user",
                              "content": _app_prompts("v1 ")[5]}]}, True)]
        hits0 = engines["a"].stats["prefix_hits"]
        zero()
        t0 = time.perf_counter()
        a_answers = _ex_in_order(port, chat, made["a"])
        a_wave_s = time.perf_counter() - t0
        a_answers += _ex_in_order(port, v1, made["a"])
        launches_a = read()
        hits = engines["a"].stats["prefix_hits"] - hits0
        stop = _http_json(port, "POST", "/debug/workload/stop", {})
        a_reqs = list(made["a"])
        alive = _http_json(port, "GET", "/.well-known/alive")
        health = _http_json(port, "GET", "/.well-known/health")
        a_singles = _ex_singles(engines["a"], a_reqs)
        judges.append(_near_tie_judge(engines["a"].params, cfg))
        a_ties: dict = {}
        a_tokens = [list(r.generated) for r in a_reqs]

        def a_faults(tokens, ties):
            return (_ex_answer_faults(a_answers, a_reqs)
                    + _ex_token_faults("a", tokens, a_singles, a_reqs,
                                       judges[-1], ties)
                    + _alive_health_faults(alive, health, gpu)
                    + ([] if hits >= 2 else [f"{hits} prefix hits"])
                    + ([] if start[0] == 201 and stop[0] == 201
                       else ["workload capture not armed"]))
        swapped = copy.deepcopy(a_tokens)
        swapped[1], swapped[2] = swapped[2], swapped[1]
        checks["a_wave"] = (a_faults(a_tokens, a_ties), a_faults(swapped, {}))
        a_chat = a_reqs[:len(chat)]
        out["a"] = {"prompt_tokens": [len(r.prompt_tokens) for r in a_reqs],
                    "prefix_hits": hits, "near_ties": dict(a_ties),
                    "health": health[2]["data"]["status"],
                    "tokens_0": a_tokens[0][:8]}
        judges.pop().release()

        # (b) the int8 example
        zero()
        b_answers = _ex_in_order(apps["b"].port, chat, made["b"])
        launches_b = read(wq=True)
        b_reqs = list(made["b"])
        b_singles = _ex_singles(engines["b"], b_reqs)
        judges.append(_near_tie_judge(
            engines["b"].params, cfg,
            float32=lambda: _ex_dequantized(engines["b"].params)))
        b_ties: dict = {}
        b_tokens = [list(r.generated) for r in b_reqs]

        def b_faults(tokens, ties):
            return (_ex_answer_faults(b_answers, b_reqs)
                    + _ex_token_faults("b", tokens, b_singles, b_reqs,
                                       judges[-1], ties))
        swapped = copy.deepcopy(b_tokens)
        swapped[1], swapped[2] = swapped[2], swapped[1]
        checks["b_int8"] = (b_faults(b_tokens, b_ties), b_faults(swapped, {}))
        out["b"] = {"near_ties": dict(b_ties), "tokens_0": b_tokens[0][:8]}
        judges.pop().release()
        _stop_app(apps["b"], *booted.pop("b"))

        # (f) started now, read after (g): a capture from the demo engine
        demo = demo_llama_engine(EngineConfig(
            max_batch=4, max_seq=128, seed=4, workload_capture=True),
            device=dev)
        demo.start()
        try:
            for p in ([5, 9, 2, 31], [7, 7, 1, 3, 200, 17], [64] * 9):
                _cli_wait(demo.submit(p, SamplingParams(
                    temperature=0.0, max_new_tokens=8)))
        finally:
            demo.stop()
        capture = demo.workload.to_jsonl()
        del demo
        files = {"capture": tmp / "demo.jsonl",
                 "changed": tmp / "demo-changed.jsonl"}
        files["capture"].write_text(capture)
        files["changed"].write_text(_ex_changed(capture))
        t_tool = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "torch_replay.py"),
             str(path), "--closed-loop", "1",
             "--device", torch.device(dev).type], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for path in files.values()]

        # (c) the bundle, from (a)'s app
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "bundle.py"),
             f"http://127.0.0.1:{port}", "--out", str(tmp / "bundle.json")],
            capture_output=True, text=True, timeout=300)
        bundle_s = time.perf_counter() - t0
        bundle = json.loads((tmp / "bundle.json").read_text()) \
            if proc.returncode == 0 else {}
        a_prompts = [list(r.prompt_tokens) for r in a_reqs]
        nulled = dict(bundle, slo=None)
        checks["c_bundle"] = (
            _ex_bundle_faults(proc.returncode, bundle, bundle_mod.SURFACES,
                              a_prompts),
            _ex_bundle_faults(proc.returncode, nulled, bundle_mod.SURFACES,
                              a_prompts))
        out["c"] = {"exit": proc.returncode, "seconds": bundle_s,
                    "bytes": (tmp / "bundle.json").stat().st_size
                    if proc.returncode == 0 else None,
                    "errors": sorted(bundle.get("errors") or {})}
        _stop_app(apps["a"], *booted.pop("a"))

        # (d) the bundle's workload on a fresh engine of the example
        workload = parse_workload(bundle.get("workload") or "")
        records = sorted(workload["records"], key=lambda r: r.get("t", 0.0))
        engine = engines["d"]
        report = replay_workload(engine, workload, closed_loop=4,
                                 timeout_s=300)
        d_reqs = list(made["d"])
        judges.append(_near_tie_judge(engine.params, cfg))
        d_ties: dict = {}
        changed = copy.deepcopy(records)
        if changed:
            toks = changed[0]["completion_tokens"]
            toks[5] = (toks[5] + 1) % cfg.vocab_size
        checks["d_replay"] = (
            _ex_replay_faults(records, d_reqs, judges[-1], d_ties)
            + ([] if report["compared"] == len(records) == 11
               else [f"compared {report['compared']} of {len(records)}"]),
            _ex_replay_faults(changed, d_reqs, judges[-1], {}))
        out["d"] = {"divergent": report["divergent"],
                    "compared": report["compared"],
                    "near_ties": dict(d_ties), "wall_s": report["wall_s"],
                    "qps": report["compared"] / report["wall_s"]
                    if report["wall_s"] else None}
        judges.pop().release()

        # (e) the capacity sweep on that engine, its setpoint to a router
        result = capacity.sweep(engine, workload, list(EX_LEVELS),
                                SLOConfig(**EX_SLO), timeout_s=300,
                                log=lambda _msg: None)
        engine.stop()
        path = tmp / "setpoint.json"
        path.write_text(json.dumps(capacity.setpoint_doc(result)))
        router = FleetRouter(object(), RouterConfig(
            autoscale=True, setpoint_file=str(path)))
        router.install(App(config=DictConfig({"APP_NAME": "router"})))
        setpoint = router.autoscaler.setpoint
        tripped = copy.deepcopy(result["levels"])
        if len(tripped) > 1:
            tripped[1]["tripped"] = True
        planted_pick = capacity.pick_max_sustainable(tripped)
        checks["e_capacity"] = (
            _ex_capacity_faults(result["levels"], result, setpoint,
                                capacity.pick_max_sustainable)
            + ([] if [e["concurrency"] for e in result["levels"]]
               == list(EX_LEVELS) else ["the sweep stopped early"]),
            _ex_capacity_faults(tripped, result, setpoint,
                                capacity.pick_max_sustainable)
            + ([] if planted_pick and planted_pick["concurrency"] == 1
               else [f"planted curve picks {planted_pick}"]))
        out["e"] = {"levels": [{k: e.get(k) for k in (
            "concurrency", "qps", "goodput_ratio", "burn_rate", "tripped",
            "wall_s")} for e in result["levels"]],
            "max_sustainable_concurrency":
                result["max_sustainable_concurrency"],
            "router_setpoint": setpoint, "slo": EX_SLO}

        # (g) the ASR worker example
        app = apps["g"]
        loop = booted["g"][0]
        transcriber = app.container.get_model("whisper")
        wcfg = transcriber.config
        utts = [_pcm(300 + i, s) for i, s in enumerate(EX_UTTERANCES)]
        broker = app.container.pubsub

        async def publish_all():
            for i, a in enumerate(utts):
                await broker.publish("asr.requests", {
                    "request_id": f"ex-{i}", "audio": a.tolist()})

        async def collect(n):
            return [(await broker.subscribe("asr.results", "smoke")).bind()
                    for _ in range(n)]
        t0 = time.perf_counter()
        asyncio.run_coroutine_threadsafe(publish_all(), loop).result(120)
        results = asyncio.run_coroutine_threadsafe(
            collect(len(utts)), loop).result(600)
        g_wall = time.perf_counter() - t0
        status, _, body = _http_json(app.port, "POST", "/transcribe",
                                     {"audio": utts[1].tolist()})
        by_id = {r["request_id"]: r for r in results}
        answers = [by_id.get(f"ex-{i}") for i in range(len(utts))] \
            + [body.get("data")]
        answered = [(u, a) for u, a in zip(utts + [utts[1]], answers) if a]
        width = transcriber.asr.max_tokens
        eot = wcfg.eot_token

        def readback(rows):
            faults, worst = [], 0.0
            for i, (u, a, toks) in enumerate(rows):
                mel = audio.log_mel_spectrogram(
                    torch.from_numpy(_padded([u], a["samples"])).to(dev),
                    n_mels=wcfg.n_mels, pad_to_frames=wcfg.audio_frames)
                t = torch.tensor([toks + [eot] * (width - len(toks))],
                                 device=dev)
                f, w = _readback_faults(transcriber.params, wcfg, mel, t,
                                        [a["n_tokens"]])
                faults += [f"answer {i}: {x}" for x in f]
                worst = max(worst, w)
            return faults, worst
        rows = [(u, a, list(a["tokens"])) for u, a in answered]
        g_faults, g_gap = readback(rows)
        g_faults += [] if len(answered) == len(utts) + 1 and status == 201 \
            else [f"{len(answered)} answers, /transcribe {status}"]
        bent = copy.deepcopy(rows)
        if bent:
            u, a, toks = bent[0]
            j = min(3, max(len(toks) - 1, 0))
            if toks:
                toks[j] = (toks[j] + wcfg.vocab_size // 2) % wcfg.vocab_size
        g_bad, g_gap_bad = readback(bent)
        checks["g_asr"] = (g_faults, g_bad)
        out["g"] = {"answers": len(answered), "worst_gap": g_gap,
                    "planted_worst_gap": g_gap_bad,
                    "n_tokens": [a["n_tokens"] for _, a in answered],
                    "utterances_per_s": len(utts) / g_wall,
                    "worker_wall_s": g_wall, "tolerance": LOGITS_TOL}

        # (f) the replay tool's two runs
        ran = [p.communicate(timeout=600) for p in procs]
        codes = [(p.returncode, err) for p, (_o, err) in zip(procs, ran)]
        procs = []
        tool_s = time.perf_counter() - t_tool
        checks["f_replay_tool"] = (_ex_tool_faults(codes[0], codes[1]),
                                   _ex_tool_faults(codes[1], codes[1]))
        out["f"] = {"exit_codes": [c for c, _ in codes],
                    "records": len(capture.splitlines()) - 1,
                    "seconds_both": tool_s}

        # (h) the kernels under (a) and (b); routes that never reach them
        zero()
        _http_json(apps["g"].port, "GET", "/.well-known/alive")
        _http_json(apps["g"].port, "GET", "/.well-known/health")
        idle = read(wq=True)
        launches = {"a": launches_a, "b": launches_b}
        checks["h_launches"] = (
            _launch_faults(launches_a) + _launch_faults(launches_b),
            _launch_faults(idle))
        out["launches"] = launches

        out["timing"] = {
            "card": smi_line,
            "a_chat_engine_ttft_s": _pcts([r.ttft_ms / 1000.0 for r in a_chat
                                           if r.ttft_ms is not None]),
            "a_chat_decode_tokens_per_s": _engine_rate(a_chat),
            "a_chat_wave_wall_s": a_wave_s,
            "b_chat_engine_ttft_s": _pcts([r.ttft_ms / 1000.0 for r in b_reqs
                                           if r.ttft_ms is not None]),
            "b_chat_decode_tokens_per_s": _engine_rate(b_reqs),
            "replay_wall_s": out["d"]["wall_s"], "replay_qps": out["d"]["qps"],
            "capacity": out["e"]["levels"],
            "setpoint": setpoint,
            "bundle_s": bundle_s, "bundle_bytes": out["c"]["bytes"],
            "asr_utterances_per_s": out["g"]["utterances_per_s"],
            "definition": "TTFT: the engine's, of the 8 /chat requests; "
            "decode tokens/s: tokens after each request's first over the "
            "span from the first first token to the last finish; replay: "
            "11 requests, closed loop 4; capacity: the same 11 at each "
            "level; bundle: the subprocess's wall; ASR: 4 utterances of "
            "1-5 s from publish to the last result"}
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for key, (loop, thread) in list(booted.items()):
            _stop_app(apps[key], loop, thread)
        for key in ("a", "b", "d"):
            if key in apps:
                apps[key].container.get_model("llama").stop()
        for judge in judges:
            judge.release()
        pool.shutdown(wait=True)
    del apps, engines
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"serve_examples: failed checks {failed}, "
                             f"planted faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out["launches"]


# ---------------------------------------------------------------- trainer
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 8
# (a) the trainer's first loss (plain float32 attention, bf16 products)
# against the serving forward's (the flash kernel) on the same weights
# and batch: the bf16 roundings of two forwards of 16 layers part them
# by about 1e-3 in the mean and a few 1e-2 per token; a target shifted
# one position moves a token's loss by about the spread of the logits
# (0.9 at this initialisation), the mean by a few 1e-2
TRAIN_LOSS_TOL = 0.01
TRAIN_TOKEN_TOL = 0.25
# (b) bf16 gradients against a float32 copy's, per layer and matrix
TRAIN_GRAD_COS = 0.99
# (c) the loss must fall by more than this over the 8 steps
TRAIN_FALL = 1e-3
# (e) ring attention at sp = 1 against plain causal attention (float32)
TRAIN_RING_TOL = 1e-5


def _train_batch(cfg, dev, b: int, s: int):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device=dev)
    return (toks[:, :-1].contiguous(), toks[:, 1:].contiguous(),
            torch.ones((b, s), dtype=torch.int32, device=dev))


def _train_first_loss_faults(loss, nll, ref_loss, ref_nll) -> list:
    faults = []
    if not abs(loss - ref_loss) <= TRAIN_LOSS_TOL:
        faults.append(f"loss {loss} vs serving {ref_loss}")
    worst = (nll - ref_nll).abs().max().item()
    if not worst <= TRAIN_TOKEN_TOL:
        faults.append(f"a token's loss {worst} from the serving forward's")
    return faults


def _grad_groups(grads: dict) -> dict:
    """Per layer and matrix (``wq[3]``), the embedding and the final
    norm: the gradient groups (b) compares."""
    out = {k: grads[k] for k in grads if k != "layers"}
    for name, g in grads["layers"].items():
        for li in range(g.shape[0]):
            out[f"{name}[{li}]"] = g[li]
    return out


def _grad_cos(grads: dict, ref: dict) -> dict:
    cos = {}
    for key, g in _grad_groups(grads).items():
        a = g.float().flatten()
        b = _grad_groups(ref)[key].float().flatten()
        den = (a.norm() * b.norm()).item()
        cos[key] = (a @ b).item() / den if den > 0 else 0.0
    return cos


def _cos_faults(cos: dict) -> list:
    return [f"{k} cos {v:.5f}" for k, v in cos.items()
            if not v >= TRAIN_GRAD_COS]


def _fall_faults(losses: list, norms: list) -> list:
    faults = [f"gradient norm {n} at step {i + 1}"
              for i, n in enumerate(norms) if not math.isfinite(n)]
    if not losses[-1] < losses[0] - TRAIN_FALL:
        faults.append(f"loss {losses[0]} -> {losses[-1]} did not fall")
    return faults


def _state_faults(a, b) -> list:
    """The leaves of two train states that are not bit for bit equal (the
    first three keys and the count)."""
    import torch
    from gofr_tpu_torch.checkpoint import flatten
    keys = [key for (key, x), (_, y) in zip(flatten(a), flatten(b))
            if x.shape != y.shape or not torch.equal(x, y)]
    return [f"{len(keys)} leaves differ: {keys[:3]}"] if keys else []


def phase_train_llama(dev, smi_line: str, cfg=None) -> dict:
    """The trainer (``gofr_tpu_torch/parallel/``) on the card:
    ``llama3_1b`` at full width and depth (vocab 128256, dim 2048, 16
    layers, 32 q / 8 KV heads, ffn 8192, tied embeddings), bf16, random
    weights from seed 0, ``make_train_state`` / ``make_train_step`` on a
    ``{dp: 1, tp: 1}`` mesh over a one-rank ``nccl`` process group
    (``file://`` rendezvous in a temporary directory: every collective of
    the step runs through NCCL), the default optimizer (clip 1.0, AdamW
    3e-4, b2 0.95, weight decay 0.1), one fixed batch of 4 x 512 tokens
    from a seeded generator. Checks, each also shown a planted fault it
    must reject:

    (a) the step's first loss within ``TRAIN_LOSS_TOL`` of the
        cross-entropy of ``llama_prefill`` through the serving route (the
        flash kernel) on the same weights and batch, and every token's
        loss within ``TRAIN_TOKEN_TOL``; planted: targets shifted by one
        position. The trainer itself launches no kernel of the
        repository (it runs ``implementation="plain"``, as JAX's runs
        ``"xla"``): the counters are read over its steps.
    (b) step 1's bf16 gradient against a float32 copy's on the card,
        cosine >= ``TRAIN_GRAD_COS`` for every layer's every matrix and
        norm, the embedding and the final norm; planted: one layer's
        ``wo`` gradient zeroed.
    (c) 8 steps on the fixed batch: the loss falls, every gradient norm
        is finite; planted: learning rate 0.
    (d) under ``torch.use_deterministic_algorithms(True)`` (with
        ``CUBLAS_WORKSPACE_CONFIG``): save at step 2 through
        ``Checkpointer``, restore (``sharding_fn``: each leaf read
        through its memory map), run steps 3-4: parameters, moments,
        ``count``, ``step`` and losses bit for bit an uninterrupted
        run's; planted: one moment leaf perturbed.
    (e) the distributed paths at world size 1: ``make_ring_attention`` at
        sp = 1 equals plain causal attention (float32, within
        ``TRAIN_RING_TOL``), and a pp = 1 GPipe step with M = 2 gives the
        dense step's first two losses within ``TRAIN_LOSS_TOL``; planted:
        the ring's diagonal block run as a full block.

    Figures: step ms (median of steps 3-8) and tokens/s, MFU as (6 N T +
    12 L H hd S T) / step time / 989 TFLOP/s, peak memory over the run,
    the optimizer's bytes, save / restore seconds, the phase's wall."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from gofr_tpu_torch.checkpoint import Checkpointer, flatten
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_prefill,
                                             param_count)
    from gofr_tpu_torch.ops.attention import xla_attention
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention,
                                                    paged_tree_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write, scatter_chunk_kv
    from gofr_tpu_torch.ops.quant import wq_gemm
    from gofr_tpu_torch.parallel import ring_attention as ring_mod
    from gofr_tpu_torch.parallel.mesh import create_mesh, init_process_group
    from gofr_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from gofr_tpu_torch.parallel.sharding import Sharding
    from gofr_tpu_torch.parallel.train import (_nll, default_optimizer,
                                               make_train_state,
                                               make_train_step,
                                               optimizer_bytes)
    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    cfg = cfg or LlamaConfig.llama3_1b()
    b, s = (TRAIN_B, TRAIN_S) if cfg.vocab_size > 1024 else (2, 16)
    counters = {"flash_attention": flash_attention,
                "paged_decode_attention": paged_decode_attention,
                "paged_chunk_attention": paged_chunk_attention,
                "paged_tree_attention": paged_tree_attention,
                "rope_kv_write": rope_kv_write,
                "scatter_chunk_kv": scatter_chunk_kv, "wq_gemm": wq_gemm}
    checks: dict = {}
    out: dict = {"phase": "train_llama", "nvidia_smi": smi_line,
                 "batch": [b, s], "dtype": str(cfg.dtype)}
    tmp = tempfile.TemporaryDirectory(prefix="gofr_train_")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    init_process_group(dev, f"file://{tmp.name}/rendezvous")
    try:
        out["backend"] = dist.get_backend()
        mesh = create_mesh({"dp": 1, "tp": 1})
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state0, _ = make_train_state(gen, cfg, mesh)
        n_params = param_count(state0.params)
        tokens, targets, mask = _train_batch(cfg, dev, b, s)
        step = make_train_step(cfg, mesh, donate=False)

        # (a) the serving forward's loss, through the flash kernel
        for fn in counters.values():
            fn.launches = 0
        with torch.no_grad():
            ref_logits, _ = llama_prefill(state0.params, tokens, cfg)
            ref_nll = _nll(ref_logits, targets)
            shifted_nll = _nll(ref_logits, targets.roll(-1, dims=1))
            del ref_logits
            out["a_serving_flash_launches"] = flash_attention.launches
            tr_nll = _nll(step.forward(state0.params, tokens), targets)
        for fn in counters.values():
            fn.launches = 0

        # (c) the training run, timed; its first loss is (a)'s
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state, losses, norms, step_s = state0, [], [], []
        for _ in range(TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            state, loss = step(state, tokens, targets, mask)
            losses.append(float(loss))
            norms.append(float(step.grad_norm))
            step_s.append(time.perf_counter() - t0)
        out["peak_memory_gb"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                                 if cuda else None)
        out["train_launches"] = {k: fn.launches
                                 for k, fn in counters.items()}
        out["optimizer_bytes"] = optimizer_bytes(state.opt_state)
        del state
        ref_loss = ref_nll.mean().item()
        checks["a_first_loss"] = (
            _train_first_loss_faults(losses[0], tr_nll, ref_loss, ref_nll),
            _train_first_loss_faults(losses[0], tr_nll,
                                     shifted_nll.mean().item(), shifted_nll))
        if any(out["train_launches"].values()):
            checks["a_first_loss"][0].append(
                f"the trainer launched {out['train_launches']}")
        out["a"] = {"loss": losses[0], "serving_loss": ref_loss,
                    "max_token_diff": (tr_nll - ref_nll).abs().max().item(),
                    "shifted_serving_loss": shifted_nll.mean().item()}
        del tr_nll, ref_nll, shifted_nll
        flat = step_s[2:]
        step_ms = statistics.median(flat) * 1e3
        tokens_per_step = b * s
        flops = (6 * n_params * tokens_per_step
                 + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * s
                 * tokens_per_step)
        out["c"] = {"losses": losses, "grad_norms": norms,
                    "step_ms": [x * 1e3 for x in step_s]}
        out.update({"step_ms_median_3_8": step_ms,
                    "tokens_per_s": tokens_per_step / (step_ms / 1e3),
                    "flops_per_step": flops,
                    "mfu": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                    "params": n_params})
        planted_state, planted_losses = state0, []
        lr0 = make_train_step(cfg, mesh, donate=False,
                              optimizer=default_optimizer(0.0))
        for _ in range(3):
            planted_state, loss = lr0(planted_state, tokens, targets, mask)
            planted_losses.append(float(loss))
        del planted_state
        checks["c_loss_falls"] = (_fall_faults(losses, norms),
                                  _fall_faults(planted_losses, norms))

        # (b) step 1's gradient against a float32 copy's
        _, grads = step.loss_and_grads(state0.params, tokens, targets, mask)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params32 = {k: ({n: w.float() for n, w in v.items()}
                        if isinstance(v, dict) else v.float())
                    for k, v in state0.params.items()}
        step32 = make_train_step(cfg32, mesh, donate=False)
        _, grads32 = step32.loss_and_grads(params32, tokens, targets, mask)
        del params32
        cos = _grad_cos(grads, grads32)
        grads["layers"]["wo"][cfg.n_layers // 2].zero_()
        checks["b_grad_cos"] = (_cos_faults(cos),
                                _cos_faults(_grad_cos(grads, grads32)))
        out["b"] = {"min_cos": min(cos.values()),
                    "min_cos_group": min(cos, key=cos.get),
                    "groups": len(cos)}
        del grads, grads32
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (d) resume, bit for bit, deterministic
        env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            ckpt = Checkpointer(Path(tmp.name) / "ckpt", keep=1)
            ref, ref_losses = state0, []
            for i in range(4):
                ref, loss = step(ref, tokens, targets, mask)
                ref_losses.append(float(loss))
                if i == 1:
                    sync()
                    t0 = time.perf_counter()
                    ckpt.save(2, ref)
                    save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = ckpt.restore(2, like=state0,
                                   sharding_fn=lambda key: Sharding(mesh, ()))
            sync()
            restore_s = time.perf_counter() - t0
            adam = resumed.opt_state[1][0]
            mu = {**adam.mu, "final_norm": adam.mu["final_norm"] + 1e-3}
            bent = dataclasses.replace(resumed, opt_state=(
                resumed.opt_state[0],
                (adam._replace(mu=mu), *resumed.opt_state[1][1:])))
            del adam, mu
            runs = []
            for start in (resumed, bent):
                st, ls = start, []
                for _ in range(2):
                    st, loss = step(st, tokens, targets, mask)
                    ls.append(float(loss))
                runs.append(_state_faults(st, ref) + (
                    [] if ls == ref_losses[2:] else [f"losses {ls}"]))
                del st
            del resumed, bent, ref
        finally:
            torch.use_deterministic_algorithms(False)
            if env_before is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
        state_bytes = sum(t.numel() * t.element_size()
                          for _, t in flatten(state0))
        checks["d_resume"] = (runs[0], runs[1])
        out["d"] = {"losses_3_4": ref_losses[2:], "save_s": save_s,
                    "restore_s": restore_s, "state_gb": state_bytes / 1e9}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (e) ring attention at sp = 1, and a pp = 1 pipeline with M = 2
        rmesh = create_mesh({"sp": 1})
        rgen = torch.Generator(device=dev)
        rgen.manual_seed(2)
        q, k, v = (torch.randn(b, s, cfg.n_heads, cfg.head_dim,
                               generator=rgen, device=dev)
                   for _ in range(3))
        ring = ring_mod.make_ring_attention(rmesh, "sp")
        want = xla_attention(q, k, v, causal=True)
        ring_err = (ring(q, k, v) - want).abs().max().item()
        mode = ring_mod._block_mode
        ring_mod._block_mode = lambda src, rank: ring_mod.FULL
        try:
            bent_err = (ring(q, k, v) - want).abs().max().item()
        finally:
            ring_mod._block_mode = mode
        del q, k, v, want
        pmesh = create_mesh({"dp": 1, "pp": 1})
        pipe = make_pipeline_train_step(cfg, pmesh, num_microbatches=2,
                                        donate=False)
        micro = [t.reshape(2, b // 2, s) for t in (tokens, targets, mask)]
        pstate, pipe_losses = state0, []
        for _ in range(2):
            pstate, loss = pipe(pstate, *micro)
            pipe_losses.append(float(loss))
        del pstate

        def e_faults(err):
            faults = [] if err <= TRAIN_RING_TOL else [f"ring max err {err}"]
            return faults + [
                f"pipeline loss {p} vs dense {d}" for p, d in
                zip(pipe_losses, losses[:2]) if not abs(p - d) <=
                TRAIN_LOSS_TOL]

        checks["e_distributed"] = (e_faults(ring_err), e_faults(bent_err))
        out["e"] = {"ring_max_err": ring_err, "planted_ring_err": bent_err,
                    "pipeline_losses": pipe_losses}
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    del state0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = {k: v[0] for k, v in checks.items()}
    planted = {k: v[1] for k, v in checks.items()}
    out.update({"tolerances": {"loss": TRAIN_LOSS_TOL,
                               "token": TRAIN_TOKEN_TOL,
                               "grad_cos": TRAIN_GRAD_COS,
                               "fall": TRAIN_FALL, "ring": TRAIN_RING_TOL},
                "phase_wall_s": time.perf_counter() - t_phase,
                "failed_checks": failed, "planted": planted})
    emit(out)
    if any(failed.values()) or not all(planted.values()):
        raise AssertionError(f"train_llama: failed checks {failed}, planted "
                             f"faults that passed: "
                             f"{[k for k, v in planted.items() if not v]}")
    return out


# ------------------------------------------------------------ serve_tp

#: Llama-3-70B's width cut to this many of its 80 layers
TP_LAYERS = 4
#: the collectives' timeout in serve_tp's rank processes
TP_TIMEOUT_S = 120.0
#: one transfer size of the host-staged all-reduce timing
TP_AR_ROWS = 8


def _tp_config(layers: int = TP_LAYERS):
    """Llama-3-70B at full width (dim 8192, 64 q / 8 KV heads, head_dim
    128, ffn 28672, vocabulary 128256), ``layers`` of its 80, bf16."""
    from gofr_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.llama3_70b().scaled(n_layers=layers)


def _tp_engine_config(cfg):
    """serve_tp's engine: ``serve_config`` on the paged layout read
    through its dense view (the mesh path's layout, run by the reference
    too), speculation on with 1-gram drafts at full depth whenever the
    lookup proposes (``spec_adaptive=False``: the adaptive controller
    prices drafts by wall-clock time, so two runs would draft
    differently)."""
    from gofr_tpu_torch.serving.app import serve_config
    return serve_config(cfg, paged_attention="view", speculative=True,
                        spec_ngram=1, spec_adaptive=False)


def _tp_workload(vocab: int) -> list:
    """serve_tp's waves, each served once the one before it ended: four
    200-token prompts at once (TTFT and decode tokens/s at batch 4); a
    320-token shared prefix (five pages) with two suffixes, one after the
    other (the second is a prefix hit); a 1100-token prompt (wider than
    the 1024 bucket: it walks); two prompts of a short cycle repeated
    (1-gram drafts: speculative passes). Token ids from a fixed seed."""
    import numpy as np
    rng = np.random.default_rng(24)

    def ids(n):
        return rng.integers(min(1000, vocab // 4), vocab, size=n).tolist()

    shared = ids(320)
    cycle_a, cycle_b = ids(6), ids(9)
    return [[(ids(200), 32) for _ in range(4)],
            [(shared + ids(24), 32)], [(shared + ids(40), 32)],
            [(ids(1100), 16)],
            [((cycle_a * 50)[:300], 32), ((cycle_b * 40)[:300], 32)]]


def _tp_planted_wave(workload: list) -> list:
    """The planted runs' wave: the batch of four, 4 new tokens each (a
    wrong model parts from the reference at once)."""
    return [[(prompt, 4) for prompt, _ in workload[0]]]


def _tp_serve(engine, workload: list) -> dict:
    """Serve ``workload`` (greedy) on an engine, warmed up here (its
    decode graphs and verify widths; the prefills stay lazy): every
    request's tokens and TTFT, the batch-4 wave's decode tokens/s, the
    counters. A wave's requests are queued under the scheduler's lock,
    so the engine admits the wave whole in every run: the same groups,
    the same products."""
    from gofr_tpu_torch.serving.engine import SamplingParams
    warm_s = engine.warmup()
    engine.start()
    reqs, waves = [], []
    t0 = time.perf_counter()
    for wave in workload:
        with engine.waiting._lock:
            batch = [engine.submit(list(prompt), SamplingParams(
                temperature=0.0, max_new_tokens=n)) for prompt, n in wave]
        end = time.time() + 300
        while time.time() < end and any(
                r.finished_at is None and r.error is None for r in batch):
            time.sleep(0.002)
        reqs += batch
        decoded = sum(max(0, len(r.generated) - 1) for r in batch)
        first = min((r.first_token_at for r in batch
                     if r.first_token_at is not None), default=None)
        last = max((r.finished_at for r in batch
                    if r.finished_at is not None), default=None)
        waves.append(decoded / (last - first)
                     if first is not None and last and last > first
                     else None)
    return {"tokens": [list(r.generated) for r in reqs],
            "prompts": [list(r.prompt_tokens) for r in reqs],
            "errors": [r.error for r in reqs],
            "ttft_ms": [r.ttft_ms for r in reqs],
            "decode_tok_s_batch4": waves[0],
            "ttft_ms_batch4_p50": float(sorted(
                r.ttft_ms or 0.0 for r in reqs[:4])[1]),
            "ttft_ms_walk": reqs[6].ttft_ms if len(reqs) > 6 else None,
            "wall_s": time.perf_counter() - t0, "warmup_s": warm_s,
            "stats": {k: engine.stats[k] for k in (
                "prefix_hits", "spec_passes", "graph_captures",
                "graph_replays", "prefill_calls", "decode_passes")}}


def _tp_counts() -> dict:
    """The launch counters of the kernels serve_tp's path runs: flash
    (prefill) and the slab write (the prompt's K/V, the view's
    write-backs)."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk_kv
    return {"flash_attention": flash_attention.launches,
            "scatter_chunk_kv": scatter_chunk_kv.launches}


def _tp_zero_counts() -> None:
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk_kv
    flash_attention.launches = 0
    scatter_chunk_kv.launches = 0


def _tp_params(cfg, dev, planted: bool = False):
    """The model's weights from seed 0 on ``dev``; ``planted``: the K and
    V projections' second half of columns (the KV heads rank 1 holds at
    tp = 2) replaced by the first half, so rank 1 holds rank 0's KV
    heads."""
    import torch
    from gofr_tpu_torch.models.llama import llama_init
    params = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if planted:
        half = cfg.n_kv_heads // 2 * cfg.head_dim
        for name in ("wk", "wv"):
            w = params["layers"][name]
            w[..., half:] = w[..., :half]
    return params


def _tp_rank(rank: int, world: int, root: str, rendezvous: str,
             out_dir: str, device: str, cfg) -> None:
    """One rank process of serve_tp (b): ``gloo`` on the card, the
    kernels ``phase_build`` made (none rebuilt), the tp engine of
    Llama-3-70B width on this rank's shards; the leader serves the
    workload, the follower follows. Then the same with the planted
    fault. Writes its results, or its traceback, into ``out_dir``."""
    import gc
    import json
    import os
    import traceback
    out = Path(out_dir) / f"rank{rank}.json"
    try:
        sys.path.insert(0, root)
        import torch
        import torch.distributed as dist
        from gofr_tpu_torch.ops import _build
        missing = [n for n in _build.SOURCES
                   if not _build.library_path(n).exists()]
        if missing and torch.device(device).type == "cuda":
            raise RuntimeError(f"kernels not built by phase_build: "
                               f"{missing}")
        from gofr_tpu_torch.parallel.mesh import (create_mesh,
                                                  init_process_group)
        from gofr_tpu_torch.serving.glue import llama_engine
        from gofr_tpu_torch.serving.lockstep import follow
        dev = init_process_group(device, f"file://{rendezvous}", rank=rank,
                                 world_size=world, backend="gloo",
                                 timeout_s=TP_TIMEOUT_S)
        cuda = dev.type == "cuda"
        mesh = create_mesh({"tp": world})
        ec = _tp_engine_config(cfg)
        workload = _tp_workload(cfg.vocab_size)
        result = {"rank": rank, "backend": mesh.backend,
                  "device": str(mesh.device)}

        def free():
            # an engine's reference cycles (its planes' callbacks) hold
            # its shards and pools until the collector runs
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        def build(planted: bool):
            # one rank at a time holds the whole tree (11.0 GB) while
            # it cuts its shards
            engine = None
            for turn in range(world):
                if turn == rank:
                    params = _tp_params(cfg, dev, planted)
                    engine = llama_engine(params, cfg, ec, mesh=mesh)
                    del params
                    free()
                dist.barrier(group=mesh.control)
            return engine

        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        engine = build(False)
        result["weight_bytes"] = _tree_bytes(engine.params)
        result["pool_bytes"] = engine._kv_bytes_total
        result["kv_heads"] = int(engine.k_cache.shape[1])
        dist.barrier(group=mesh.control)
        _tp_zero_counts()
        if rank == mesh.leader:
            try:
                result["run"] = _tp_serve(engine, workload)
            finally:
                engine.stop()
        else:
            result["follower_ops"] = follow(engine)
        result["launches"] = _tp_counts()
        result["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else None)
        del engine
        free()
        # planted: rank 1 holds rank 0's KV heads
        engine = build(True)
        if rank == mesh.leader:
            try:
                result["planted"] = _tp_serve(engine,
                                              _tp_planted_wave(workload))
            finally:
                engine.stop()
        else:
            follow(engine)
        del engine
        free()
        # the host-staged all-reduce against gloo's own CUDA path, at a
        # decode step's [8, 8192] bf16 partial sum
        x = torch.randn(TP_AR_ROWS, cfg.dim, device=dev).bfloat16()
        y = torch.empty_like(x)
        group = mesh.group("tp")

        def host_staged():
            host = x.cpu()
            dist.all_reduce(host, group=group)
            y.copy_(host)

        def gloo_cuda():
            y.copy_(x)
            dist.all_reduce(y, group=group)

        staged, native = [], []
        for _ in range(3):
            for times, fn in ((staged, host_staged), (native, gloo_cuda)):
                dist.barrier(group=mesh.control)
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(20):
                    fn()
                if cuda:
                    torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) / 20 * 1e3)
        result["allreduce_ms"] = {"host_staged": min(staged),
                                  "gloo_cuda": min(native)}
        dist.barrier(group=mesh.control)
        dist.destroy_process_group()
        out.write_text(json.dumps(result))
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        os._exit(1)


def _tp_token_faults(label: str, run: dict, ref: dict, judge,
                     ties: dict) -> list:
    """Every request's tokens equal the reference's, or first differ at
    a near tie (``_near_tie_judge`` through a teacher-forced prefill)."""
    faults = []
    if any(run["errors"]):
        return [f"{label} errors {run['errors']}"]
    for i, (got, want, prompt) in enumerate(zip(run["tokens"],
                                                ref["tokens"],
                                                ref["prompts"])):
        faults += _tie_or_fault(f"{label} request {i}", got, want, prompt,
                                judge, ties)
    return faults


def phase_serve_tp(dev, smi_line: str, cfg=None) -> dict:
    """Serving on a tensor-parallel mesh at Llama-3-70B's width
    (``TP_LAYERS`` of its 80 layers, random bf16 weights from seed 0, 11.0
    GB at 4; about 5.5 GB a rank at tp = 2), before train_mesh.

    (a) flash at Hq 32 / Hkv 4 / D 128 and the slab write at Hkv 4 (one
    rank's shapes) against their plain versions with their planted
    faults: kernel rows ``flash_attention_tp2`` and
    ``kv_write_prefill_tp2`` (checked in ``main`` beside the others),
    their launches counted in (b)'s ranks.

    The reference: the unsharded port engine on the same weights
    (``_tp_engine_config``: the paged layout through its view, as the
    mesh path serves) on the workload (``_tp_workload``: a batch of four,
    a prefix hit, a prompt walked past the widest bucket, speculative
    passes).

    (c) tp = 1 over a one-rank ``nccl`` group: ``llama_engine(mesh=)``
    with its decode dispatch captured (the graph holds the all-reduces):
    tokens bit-equal to the reference's and graph captures; planted: the
    embedding's vocabulary shard read at rank 1's offset.

    (b) tp = 2 as two rank processes on the card over ``gloo``
    (collectives staged through the host): the leader serves the
    workload, the follower follows; tokens equal to the reference's or
    parting at a near tie; each rank's weight and pool bytes about half
    the reference's; launches of flash and the slab write; planted:
    rank 1 holding rank 0's KV heads must be rejected. Timing: TTFT and
    decode tokens/s, labelled "gloo, host-staged collectives, one card",
    beside the reference's; the host-staged all-reduce beside gloo's own
    CUDA path. ``cfg``: another model (a CPU rehearsal at a small one:
    (c) then runs ``gloo`` and captures nothing, and no kernel
    launches)."""
    import gc
    import json
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from gofr_tpu_torch.parallel.mesh import create_mesh, init_process_group
    from gofr_tpu_torch.serving.glue import llama_engine
    t_phase = time.perf_counter()
    cfg = cfg or _tp_config()
    cuda = torch.device(dev).type == "cuda"
    ec = _tp_engine_config(cfg)
    workload = _tp_workload(cfg.vocab_size)
    failed: dict = {}
    planted: dict = {}
    steps_s: dict = {}

    def step_done(name: str) -> None:
        steps_s[name] = time.perf_counter() - t_phase
        emit({"phase": "serve_tp_step", "step": name, "s": steps_s[name]})

    # the reference: one engine, unsharded
    params = _tp_params(cfg, dev)
    weight_bytes = _tree_bytes(params)
    ref_engine = llama_engine(params, cfg, ec, device=dev)
    pool_bytes = ref_engine._kv_bytes_total
    try:
        ref = _tp_serve(ref_engine, workload)
    finally:
        ref_engine.stop()
    del ref_engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    step_done("reference")
    failed["reference"] = ([f"reference errors {ref['errors']}"]
                           if any(ref["errors"]) else []) \
        + ([] if ref["stats"]["prefix_hits"] >= 1 else ["no prefix hit"]) \
        + ([] if ref["stats"]["spec_passes"] >= 1 else
           ["no speculative pass"])

    # (c) tp = 1 over a one-rank nccl group, the decode graph captured
    tmp = tempfile.TemporaryDirectory()
    init_process_group(dev, f"file://{tmp.name}/rendezvous",
                       backend="nccl" if cuda else "gloo",
                       timeout_s=TP_TIMEOUT_S)
    try:
        mesh = create_mesh({"tp": 1})
        one = llama_engine(params, cfg, ec, mesh=mesh)
        try:
            tp1 = _tp_serve(one, workload)
        finally:
            one.stop()
        del one
        bad = llama_engine(params, cfg, ec, mesh=mesh)
        bad.tp.index = 1            # planted: rank 1's vocabulary offset
        try:
            tp1_planted = _tp_serve(bad, _tp_planted_wave(workload))
        finally:
            bad.stop()
        del bad
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    step_done("tp1_nccl")
    failed["c"] = ([] if tp1["tokens"] == ref["tokens"] else
                   ["tp = 1 tokens differ from the reference's"]) \
        + ([] if tp1["stats"]["graph_captures"] >= 1 else
           ["no decode graph captured"])
    planted["c"] = ([] if tp1_planted["tokens"]
                    == [t[:4] for t in ref["tokens"][:4]] else
                    ["tp = 1 planted: tokens differ"])

    # (b) tp = 2: two rank processes sharing the card over gloo
    ranks_dir = tempfile.TemporaryDirectory()
    rendezvous = Path(ranks_dir.name) / "rendezvous"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tp_rank,
                         args=(r, 2, str(ROOT), str(rendezvous),
                               ranks_dir.name, str(dev), cfg))
             for r in range(2)]
    t_ranks = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks_s = time.perf_counter() - t_ranks
    errors = {r: (Path(ranks_dir.name) / f"rank{r}.err").read_text()
              for r in range(2)
              if (Path(ranks_dir.name) / f"rank{r}.err").exists()}
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"serve_tp: a rank failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(errors.values()))
    results = [json.loads((Path(ranks_dir.name) / f"rank{r}.json")
                          .read_text()) for r in range(2)]
    step_done("tp2_gloo")
    ranks_dir.cleanup()
    lead, follower = results
    tp2 = lead["run"]
    # the near-tie judge reads the model in float32: the weights again
    params = _tp_params(cfg, dev)
    judge = _near_tie_judge(params, cfg)
    ties: dict = {}
    failed["b"] = _tp_token_faults("tp = 2", tp2, ref, judge, ties) \
        + ([] if tp2["stats"]["prefix_hits"] >= 1 else ["no prefix hit"]) \
        + ([] if tp2["stats"]["spec_passes"] >= 1 else
           ["no speculative pass"]) \
        + ([] if tp2["stats"]["graph_captures"] == 0 else
           ["a gloo mesh captured a graph"])
    for r in results:
        for key, full in (("weight_bytes", weight_bytes),
                          ("pool_bytes", pool_bytes)):
            if not 0.45 <= r[key] / full <= 0.55:
                failed["b"].append(f"rank {r['rank']} {key} {r[key]} of "
                                   f"{full}")
        if r["kv_heads"] != cfg.n_kv_heads // 2:
            failed["b"].append(f"rank {r['rank']} holds {r['kv_heads']} "
                               f"KV heads")
    launches = {k: lead["launches"][k] + follower["launches"][k]
                for k in lead["launches"]}
    failed["b"] += [f"{k}: no launch on the tp path" for k, n in
                    launches.items() if n == 0]
    planted_ties: dict = {}
    planted["b"] = _tp_token_faults(
        "tp = 2 planted", lead["planted"],
        {"prompts": ref["prompts"][:4],
         "tokens": [t[:4] for t in ref["tokens"][:4]]}, judge, planted_ties)
    judge.release()
    del params, judge
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    label = "gloo, host-staged collectives, one card"
    timing = {
        "card": smi_line,
        "tp2": {"label": label, "ttft_ms_batch4_p50":
                tp2["ttft_ms_batch4_p50"], "ttft_ms_walk": tp2["ttft_ms_walk"],
                "decode_tok_s_batch4": tp2["decode_tok_s_batch4"],
                "wall_s": tp2["wall_s"]},
        "unsharded": {"ttft_ms_batch4_p50": ref["ttft_ms_batch4_p50"],
                      "ttft_ms_walk": ref["ttft_ms_walk"],
                      "decode_tok_s_batch4": ref["decode_tok_s_batch4"],
                      "wall_s": ref["wall_s"]},
        "tp1_nccl_graph": {"ttft_ms_batch4_p50": tp1["ttft_ms_batch4_p50"],
                           "ttft_ms_walk": tp1["ttft_ms_walk"],
                           "decode_tok_s_batch4": tp1["decode_tok_s_batch4"],
                           "wall_s": tp1["wall_s"]},
        "allreduce_8x8192_bf16_ms": lead["allreduce_ms"]}
    line = {"phase": "serve_tp", "model": "llama3_70b width, "
            f"{TP_LAYERS} of 80 layers, bf16, seed 0",
            "weight_bytes": weight_bytes, "pool_bytes": pool_bytes,
            "rank_bytes": [{k: r[k] for k in ("rank", "weight_bytes",
                                               "pool_bytes", "peak_bytes",
                                               "kv_heads", "backend")}
                           for r in results],
            "follower_ops": follower["follower_ops"],
            "stats": {"reference": ref["stats"], "tp2": tp2["stats"],
                      "tp1": tp1["stats"]},
            "launches": launches,
            "per_rank_launches": [r["launches"] for r in results],
            "near_ties": ties, "planted_near_ties": planted_ties,
            "timing": timing, "failed_checks": failed, "planted": planted,
            "ranks_s": ranks_s, "steps_s": steps_s,
            "phase_wall_s": time.perf_counter() - t_phase}
    emit(line)
    bad = {k: v for k, v in failed.items() if v}
    if bad:
        raise AssertionError(f"serve_tp: {bad}")
    missed = [k for k, v in planted.items() if not v]
    if missed:
        raise AssertionError(f"serve_tp: planted faults passed in {missed}")
    return launches


# ---------------------------------------------------------- train_mesh

#: the rank processes of train_mesh (four, sharing the one card over gloo)
MESH_WORLD = 4
#: their collectives' timeout: a staged all-reduce of a step's 1.24 GB of
#: gradients takes seconds, a checkpoint's gather of 7.4 GB tens
MESH_TIMEOUT_S = 300.0
#: how long a rank waits for the parent's plan (the one-rank references)
MESH_PLAN_WAIT_S = 600.0
#: (a) steps (the checkpoint of (e) after the second); (b) GPipe steps and
#: microbatches; (c) MoE steps and its batch
MESH_STEPS, MESH_PIPE_STEPS, MESH_PIPE_M = 4, 3, 4
MESH_MOE_STEPS, MESH_MOE_B, MESH_MOE_S = 3, 4, 256
#: (d)'s q / k / v: [1, 8192, 32, 64], llama3_1b's 32 heads of 64
MESH_RING_SHAPE = (1, 8192, 32, 64)
#: (d) ring attention at sp = 4 against plain causal attention on one rank,
#: both float32 (no TF32: torch's default for matmuls), per tensor:
#: max |ring - plain| <= MESH_RING_TOL * max |plain|. The two sum the same
#: products in other orders (four key blocks merged by the running
#: softmax against one softmax over 8192 keys): float32's unit roundoff
#: 2^-24 times the few hundred terms an element's sums chain gives errors
#: near 1e-6 of the largest value; a block run in the wrong mode or from
#: the wrong rank moves the output and gradients by a large part of it
MESH_RING_TOL = 1e-4
#: (c): a step's loss may part from the one-rank step's by this many times
#: the distance between the one-rank step and the same step with the
#: mesh's dp roundings (``_moe_loss_tols``), where that is above
#: TRAIN_LOSS_TOL; the mesh's losses must also lie within TRAIN_LOSS_TOL
#: of that step's
MESH_MOE_SPREAD = 2.0
#: (a) the step's global gradient norm against the one-rank step's,
#: relative: both are float32 sums of squares of bf16 gradients that
#: differ by bf16 rounding (about 2^-8 an element, random in sign); a
#: norm over one rank's shards alone is about 1 / sqrt(tp) of it
MESH_NORM_RTOL = 0.01
#: the comm.py functions that move tensors between ranks (timed, train_mesh)
MESH_COLLECTIVES = ("_all_reduce", "_all_gather", "_reduce_scatter",
                    "_exchange", "_sum_", "send", "recv")


class _CommTimer:
    """Host ms spent in ``comm.py``'s collectives while active: every
    function of ``MESH_COLLECTIVES`` is wrapped, the card synchronised
    before and after each outermost call (queued compute is not counted
    in it; a collective on a ``gloo`` group blocks the host anyway)."""

    def __init__(self, dev) -> None:
        from gofr_tpu_torch.parallel import comm
        self.comm, self.dev = comm, dev
        self.ms, self.calls, self._depth, self._saved = 0.0, 0, 0, {}

    def _sync(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _wrap(self, fn):
        def timed(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._sync()
            t0 = time.perf_counter()
            self._depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                self._sync()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.calls += 1
        return timed

    def __enter__(self):
        for name in MESH_COLLECTIVES:
            self._saved[name] = getattr(self.comm, name)
            setattr(self.comm, name, self._wrap(self._saved[name]))
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self._saved.items():
            setattr(self.comm, name, fn)


def _capturing(optimizer):
    """``optimizer`` that keeps the gradients of its first update (the
    first step's, summed over dp, before clipping) in ``seen``."""
    from gofr_tpu_torch.parallel.train import GradientTransformation
    seen: list = []

    def update(updates, state, params=None, **extra):
        if not seen:
            seen.append(updates)
        held = [updates]        # handed over, as ``train.chain`` does
        del updates
        return optimizer.update(held.pop(), state, params, **extra)

    return GradientTransformation(optimizer.init, update), seen


def _spec_items(specs, prefix: str = ""):
    """``(key, spec)`` of a spec tree, keyed as ``checkpoint.flatten``
    keys the parameter tree."""
    if isinstance(specs, dict):
        for key in sorted(specs):
            yield from _spec_items(specs[key], f"{prefix}[{key!r}]")
    else:
        yield prefix, tuple(specs)


def _leaf_specs(state, specs) -> dict:
    """Per leaf key of ``state`` (a train state or a parameter tree), its
    placement spec: a parameter's, which its gradient and Adam moments
    take too, else () (optax's ``count``, the step)."""
    from gofr_tpu_torch.checkpoint import flatten
    from gofr_tpu_torch.parallel.sharding import _match_specs
    params = state.params if hasattr(state, "params") else state
    by_param = dict(_spec_items(_match_specs(params, specs)))
    out = {}
    for key, _ in flatten(state):
        out[key] = next((spec for pkey, spec in by_param.items()
                         if key.endswith(pkey)), ())
    return out


def _digest(t) -> str:
    """sha1 of a tensor's bytes (on the host)."""
    import hashlib
    import torch
    host = t.detach().contiguous().cpu()
    return hashlib.sha1(host.view(torch.uint8).numpy().data).hexdigest()


class _HostBlock:
    """A placement for ``Checkpointer.restore(sharding_fn=)``: this rank's
    block of a leaf (``sharding.index``), kept on the host."""

    def __init__(self, sharding) -> None:
        import torch
        self.index = sharding.index
        self.device = torch.device("cpu")


def _grad_record(grads: dict, ref: dict, specs, mesh) -> dict:
    """A gradient tree of this rank's shards against the reference's
    blocks (``ref``, the same keys, on the host): per group — a layer of
    a stacked leaf, an expert of an expert-sharded one, a whole leaf
    otherwise — the float64 dot product and both squared norms, and
    whether every rank holds the group whole (else the parent sums the
    parts over the ranks that hold one); per leaf a digest, to hold dp
    replicas equal."""
    import torch
    from gofr_tpu_torch.checkpoint import flatten
    specs = _leaf_specs(grads, specs)
    refs = dict(flatten(ref))
    parts, digests = {}, {}
    for key, g in flatten(grads):
        digests[key] = _digest(g)
        spec = specs[key]
        whole = not any(spec)
        r = refs[key]
        name = key.rsplit("[", 1)[-1].strip("]'")
        if "['layers']" not in key:
            groups = [(name, (), ())]
        elif len(spec) > 1 and spec[1] is not None and g.ndim == 4:
            # experts: dim 1 is this rank's slice of the expert axis
            first = mesh.coord(spec[1]) * g.shape[1]
            groups = [(f"{name}[{li},{first + e}]", (li, e), (li, e))
                      for li in range(g.shape[0]) for e in range(g.shape[1])]
            whole = False
        else:
            groups = [(f"{name}[{li}]", (li,), (li,))
                      for li in range(g.shape[0])]
        for label, gi, ri in groups:
            a = g[gi].double()
            b = r[ri].to(g.device).double()
            parts[label] = [float((a * b).sum()), float((a * a).sum()),
                            float((b * b).sum()), whole]
            del a, b
    return {"parts": parts, "digests": digests}


def _ref_blocks(directory, mesh, specs, like) -> dict:
    """This rank's blocks of the reference gradients saved in
    ``directory`` (step 1), on the host, as a tree like ``like``."""
    from gofr_tpu_torch.checkpoint import Checkpointer
    from gofr_tpu_torch.parallel.sharding import Sharding
    spec = _leaf_specs(like, specs)
    return Checkpointer(directory).restore(
        1, like=like,
        sharding_fn=lambda key: _HostBlock(Sharding(mesh, spec[key])))


def _free(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _timed_steps(step, held: dict, batch, n: int, dev,
                 norms: bool = False):
    """``n`` steps from ``held["state"]``, which each step replaces (no
    other reference may keep an old state alive: a state is a third of
    a rank's memory): (losses, step ms, comm ms a step, gradient norms),
    each step on the host clock with the card synchronised."""
    import torch
    losses, step_ms, comm_ms, grad_norms = [], [], [], []
    for _ in range(n):
        with _CommTimer(dev) as timer:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            held["state"], loss = step(held.pop("state"), *batch)
            losses.append(float(loss))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        comm_ms.append(timer.ms)
        if norms:
            grad_norms.append(float(step.grad_norm))
    return losses, step_ms, comm_ms, grad_norms


def _gathered_host(leaf, spec, mesh):
    """A leaf whole on the host: its shards gathered over the mesh axes
    its spec names (CPU tensors over the mesh's groups), each axis's
    blocks concatenated along its dim (rows of whole runs, where a
    gather into the first dim and a move back would transpose the leaf
    twice)."""
    import torch
    import torch.distributed as dist
    host = leaf.detach().cpu().contiguous()
    for dim, axis in enumerate(spec):
        if axis is not None:
            parts = [torch.empty_like(host) for _ in range(mesh.size(axis))]
            dist.all_gather(parts, host, group=mesh.group(axis))
            host = torch.cat(parts, dim)
    return host


def _save_whole(ckpt, step_no: int, state, mesh, specs) -> dict:
    """Save ``state`` whole as step ``step_no``: the dp = 0 ranks gather
    every leaf onto the host, the first rank of the grid writes;
    every rank waits for the write. Seconds: the gather, the write, in
    all."""
    import torch.distributed as dist
    from gofr_tpu_torch.checkpoint import _rebuild, flatten
    t0 = time.perf_counter()
    spec = _leaf_specs(state, specs)
    out = {}
    if mesh.coord("dp") == 0:
        leaves = [_gathered_host(leaf, spec[key], mesh)
                  for key, leaf in flatten(state)]
        out["gather_s"] = time.perf_counter() - t0
        if mesh.rank == mesh.leader:
            t1 = time.perf_counter()
            ckpt.save(step_no, _rebuild(state, iter(leaves)))
            out["write_s"] = time.perf_counter() - t1
        del leaves
    dist.barrier(group=mesh.control)
    return {**out, "s": time.perf_counter() - t0}


def _restore_slices(ckpt, step_no: int, like, mesh, specs,
                    wrong: str | None = None) -> tuple:
    """Each rank's slice of every leaf of step ``step_no`` on its device
    (``sharding_fn``), and the seconds taken; ``wrong``: the key of a
    leaf read at the tp peer's block instead (a planted fault)."""
    from gofr_tpu_torch.parallel.mesh import Mesh
    from gofr_tpu_torch.parallel.sharding import Sharding
    spec = _leaf_specs(like, specs)
    peer = next(r for r in mesh.line("tp") if r != mesh.rank) \
        if wrong else None

    def place(key):
        at = mesh if key != wrong else Mesh(
            mesh.ranks, mesh.axis_names, peer, mesh.device)
        return Sharding(at, spec[key])

    t0 = time.perf_counter()
    restored = ckpt.restore(step_no, like=like, sharding_fn=place)
    return restored, time.perf_counter() - t0


def _mesh_job_dense(plan: dict, dev) -> dict:
    """(a) ``llama3_1b`` at ``{dp: 2, tp: 2}``: the planted runs, then
    ``MESH_STEPS`` steps under deterministic algorithms, step 1's
    gradients against the reference's, the state saved after step 2;
    (e) that checkpoint restored, every rank its slices, steps 3-4
    again, and once more with one moment leaf read at the tp peer's
    block."""
    import torch
    from gofr_tpu_torch.checkpoint import Checkpointer, _rebuild, flatten
    from gofr_tpu_torch.models.llama import llama_init
    from gofr_tpu_torch.parallel import comm
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import (llama_param_specs,
                                                  shard_params)
    from gofr_tpu_torch.parallel.train import (default_optimizer,
                                               make_train_state,
                                               make_train_step)
    cfg = plan["cfg"]
    mesh = create_mesh(plan["axes"]["a"])
    specs = llama_param_specs(mesh)
    batch = [torch.from_numpy(x) for x in plan["batch"]]
    planted = mesh.rank == plan["planted_rank"]
    out: dict = {"coords": mesh.coords(), "marks": {}}
    t_job = time.perf_counter()

    def mark(name):
        out["marks"][name] = time.perf_counter() - t_job

    def seeded():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    torch.use_deterministic_algorithms(True)
    try:
        opt, seen = _capturing(default_optimizer())
        state, _ = make_train_state(seeded(), cfg, mesh, optimizer=opt)
        out["shapes"] = {key: [list(x.shape), list(spec)]
                         for (key, x), spec in zip(
                             flatten(state.params),
                             _leaf_specs(state.params, specs).values())}
        ref = _ref_blocks(plan["dir"] / "dense_grads", mesh, specs,
                          state.params)
        step = make_train_step(cfg, mesh, optimizer=opt, donate=False)
        mark("init")

        # planted: the dp gradient sum skipped on one rank (it joins the
        # sums, and keeps its own gradients)
        reduce = comm.all_reduce_
        if planted:
            comm.all_reduce_ = lambda x, mesh, axis: (
                reduce(x.clone(), mesh, axis), x)[1] if x.ndim else \
                reduce(x, mesh, axis)
        try:
            loss, grads = step.loss_and_grads(state.params, *batch)
        finally:
            comm.all_reduce_ = reduce
        mark("planted_dp_step")
        out["planted_dp"] = {"loss": float(loss),
                             **_grad_record(grads, ref, specs, mesh)}
        del grads
        mark("planted_dp_record")
        # planted: one rank holds its tp peer's block of wo
        def swapped(c, g, d):
            p = llama_init(c, g, d)
            wo = p["layers"]["wo"]
            half = wo.shape[1] // 2
            p["layers"]["wo"] = torch.cat([wo[:, half:], wo[:, :half]], 1)
            return p

        bent = shard_params((swapped if planted else llama_init)(
            cfg, seeded(), dev), mesh, specs)
        loss, grads = step.loss_and_grads(bent, *batch)
        out["planted_wo"] = {"loss": float(loss),
                             **_grad_record(grads, ref, specs, mesh)}
        del grads, bent
        _free(dev)
        mark("planted_wo")

        _reset_peak(dev)
        ckpt = Checkpointer(plan["dir"] / "mesh_ckpt", keep=2)
        held = {"state": state}
        del state
        losses, step_ms, comm_ms, norms = [], [], [], []
        for i in range(MESH_STEPS):
            run = _timed_steps(step, held, batch, 1, dev, True)
            for acc, got in zip((losses, step_ms, comm_ms, norms), run):
                acc += got
            mark(f"step{i + 1}")
            if i == 0:
                out["grads"] = _grad_record(seen[0], ref, specs, mesh)
                seen[0] = None
                mark("grads_record")
            if i == 1 and plan["resume"]:
                out["save"] = _save_whole(ckpt, 2, held["state"], mesh,
                                          specs)
                mark("save")
        out.update({"losses": losses, "step_ms": step_ms,
                    "comm_ms": comm_ms, "grad_norms": norms,
                    "peak_bytes": _peak(dev),
                    "param_digests": {k: _digest(x) for k, x in
                                      flatten(held["state"].params)}})
        del ref
        if not plan["resume"]:
            return out
        # (e) the uninterrupted state on the host, then two resumed runs
        mark("param_digests")
        final = [x.detach().cpu() for _, x in flatten(held["state"])]
        like = _rebuild(held.pop("state"), iter(final))
        _free(dev)
        mark("final_to_host")
        moment = next(key for key in _leaf_specs(like, specs)
                      if ".mu['layers']['wo']" in key)
        for label, wrong in (("e", None), ("e_planted", moment)):
            held["state"], restore_s = _restore_slices(
                ckpt, 2, like, mesh, specs, wrong if planted else None)
            got = _timed_steps(step, held, batch, 2, dev)[0]
            differ = [key for (key, x), y in
                      zip(flatten(held.pop("state")), final)
                      if not torch.equal(x.detach().cpu(), y)]
            out[label] = {"losses": got, "differ": differ[:4],
                          "n_differ": len(differ), "restore_s": restore_s}
            _free(dev)
            mark(label)
        return out
    finally:
        torch.use_deterministic_algorithms(False)


def _mesh_job_pipe(plan: dict, dev) -> dict:
    """(b) GPipe at ``{dp: 2, pp: 2}``, M = ``MESH_PIPE_M``: one planted
    step (a stage sends the previous microbatch's activation), then
    ``MESH_PIPE_STEPS`` steps."""
    import torch
    from gofr_tpu_torch.parallel import comm
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from gofr_tpu_torch.parallel.train import make_train_state
    cfg = plan["cfg"]
    mesh = create_mesh(plan["axes"]["b"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, _ = make_train_state(gen, cfg, mesh)
    step = make_pipeline_train_step(cfg, mesh, num_microbatches=MESH_PIPE_M,
                                    donate=False)
    batch = [torch.from_numpy(x).reshape(MESH_PIPE_M, -1, x.shape[-1])
             for x in plan["pipe_batch"]]
    out: dict = {"coords": mesh.coords(),
                 "layers": int(state.params["layers"]["wq"].shape[0])}
    send, sent = comm.send, []

    def late_send(x, mesh, axis, to):
        sent.append(x)
        return send(sent[-2] if len(sent) > 1 else x, mesh, axis, to)

    if mesh.rank == plan["planted_rank"]:
        comm.send = late_send
    try:
        loss = step(state, *batch)[1]
    finally:
        comm.send = send
    out["planted"] = {"loss": float(loss)}
    del sent[:]
    held = {"state": state}
    del state
    _free(dev)
    _reset_peak(dev)
    losses, step_ms, comm_ms, _ = _timed_steps(step, held, batch,
                                               MESH_PIPE_STEPS, dev)
    out.update({"losses": losses, "step_ms": step_ms, "comm_ms": comm_ms,
                "peak_bytes": _peak(dev)})
    return out


def _mesh_job_moe(plan: dict, dev) -> dict:
    """(c) the MoE model at ``{dp: 2, ep: 2}``: a planted forward and
    backward (``ExpertShard.first`` one expert off on one rank), then
    ``MESH_MOE_STEPS`` steps, step 1's gradients against the
    reference's."""
    import torch
    from gofr_tpu_torch.models import moe as moe_mod
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import moe_param_specs
    from gofr_tpu_torch.parallel.train import (default_optimizer,
                                               make_train_state,
                                               make_train_step)
    c = plan["moe_cfg"]
    mesh = create_mesh(plan["axes"]["c"])
    specs = moe_param_specs(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opt, seen = _capturing(default_optimizer())
    state, _ = make_train_state(gen, c, mesh, optimizer=opt,
                                init_fn=moe_mod.moe_init,
                                specs_fn=moe_param_specs)
    ref = _ref_blocks(plan["dir"] / "moe_grads", mesh, specs, state.params)

    def fwd(params, tokens):
        return moe_mod.moe_prefill(params, tokens, c, implementation="plain",
                                   mesh=mesh)[0]

    step = make_train_step(c, mesh, forward_fn=fwd, optimizer=opt,
                           donate=False)
    batch = [torch.from_numpy(x) for x in plan["moe_batch"]]
    out: dict = {"coords": mesh.coords(),
                 "experts": int(state.params["layers"]["w1"].shape[1])}
    shard = moe_mod._expert_shard

    def off_by_one(m, cfg):
        s = shard(m, cfg)
        return s if s is None else s._replace(first=s.first + 1)

    if mesh.rank == plan["planted_rank"]:
        moe_mod._expert_shard = off_by_one
    try:
        loss, grads = step.loss_and_grads(state.params, *batch)
    finally:
        moe_mod._expert_shard = shard
    out["planted"] = {"loss": float(loss),
                      **_grad_record(grads, ref, specs, mesh)}
    del grads
    held = {"state": state}
    del state
    _free(dev)
    _reset_peak(dev)
    losses, step_ms, comm_ms, _ = _timed_steps(step, held, batch, 1, dev)
    out["grads"] = _grad_record(seen[0], ref, specs, mesh)
    seen[0] = None
    del ref
    rest = _timed_steps(step, held, batch, MESH_MOE_STEPS - 1, dev)
    out.update({"losses": losses + rest[0], "step_ms": step_ms + rest[1],
                "comm_ms": comm_ms + rest[2], "peak_bytes": _peak(dev)})
    return out


def _mesh_job_ring(plan: dict, dev) -> dict:
    """(d) ``make_ring_attention`` at sp = world: the output and the
    input gradients of the saved q / k / v and output gradient against
    the reference's (error over the reference's largest magnitude), with
    the diagonal block run as a full block, and with the first hop
    rotated the wrong way, as planted faults."""
    import numpy as np
    import torch
    from gofr_tpu_torch.parallel import comm
    from gofr_tpu_torch.parallel import ring_attention as ring_mod
    from gofr_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(plan["axes"]["d"])
    ring = ring_mod.make_ring_attention(mesh, "sp")
    with np.load(plan["dir"] / "ring.npz") as data:
        arrays = {k: data[k] for k in data.files}
    q, k, v = (torch.from_numpy(arrays[n]).to(dev).requires_grad_()
               for n in "qkv")
    do = torch.from_numpy(arrays["do"]).to(dev)
    want = {n: torch.from_numpy(arrays[n]).to(dev)
            for n in ("out", "dq", "dk", "dv")}
    scale = {n: w.abs().max().item() for n, w in want.items()}

    def run():
        out = ring(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        return {n: ((got - want[n]).abs().max().item() / scale[n])
                for n, got in zip(("out", "dq", "dk", "dv"),
                                  (out, *grads))}

    result: dict = {"coords": mesh.coords()}
    _reset_peak(dev)
    times, comm_ms = [], []
    for _ in range(2):
        with _CommTimer(dev) as timer:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            result["err"] = run()
            times.append((time.perf_counter() - t0) * 1e3)
        comm_ms.append(timer.ms)
    result.update({"ms": times, "comm_ms": comm_ms,
                   "peak_bytes": _peak(dev)})
    mode = ring_mod._block_mode
    ring_mod._block_mode = lambda src, rank: (
        ring_mod.FULL if src == rank else mode(src, rank))
    try:
        result["planted_diagonal"] = run()
    finally:
        ring_mod._block_mode = mode
    ppermute, hops = comm.ppermute, []

    def backward_hop(x, mesh, axis, perm):
        hops.append(axis)
        if len(hops) <= 2:          # k and v of the first hop
            perm = [(d, s) for s, d in perm]
        return ppermute(x, mesh, axis, perm)

    comm.ppermute = backward_hop
    try:
        result["planted_hop"] = run()
    finally:
        comm.ppermute = ppermute
    return result


_MESH_JOBS = {"a": _mesh_job_dense, "b": _mesh_job_pipe,
              "c": _mesh_job_moe, "d": _mesh_job_ring}


def _kernel_counters() -> dict:
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention,
                                                    paged_tree_attention)
    from gofr_tpu_torch.ops.paged_kv import rope_kv_write, scatter_chunk_kv
    from gofr_tpu_torch.ops.quant import wq_gemm
    return {"flash_attention": flash_attention,
            "paged_decode_attention": paged_decode_attention,
            "paged_chunk_attention": paged_chunk_attention,
            "paged_tree_attention": paged_tree_attention,
            "rope_kv_write": rope_kv_write,
            "scatter_chunk_kv": scatter_chunk_kv, "wq_gemm": wq_gemm}


def _mesh_rank(rank: int, world: int, root: str, out_dir: str) -> None:
    """One rank process of train_mesh: waits for the parent's plan
    (``plan.pkl`` in ``out_dir``), joins the world on ``plan["device"]``
    (``{rank}`` in it: the rank's own card) over ``plan["backend"]``
    (rendezvous ``out_dir/rendezvous``), runs every job of
    ``plan["jobs"]`` on a mesh of its own, writes its results (or its
    traceback) into ``out_dir``. The parent kills a rank it gave up on."""
    import json
    import os
    import pickle
    import traceback
    entered_at = time.time()
    # cuBLAS reads it at its first handle: (e)'s deterministic steps;
    # the allocator at its first allocation: four ranks share the card,
    # and a rank's free blocks must be of use to it at any size
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        sys.path.insert(0, root)
        import torch
        import torch.distributed as dist
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        from gofr_tpu_torch.ops import _build
        from gofr_tpu_torch.parallel.mesh import init_process_group
        imported_at = time.time()
        plan_path = Path(out_dir, "plan.pkl")
        give_up = time.monotonic() + MESH_PLAN_WAIT_S
        while not plan_path.exists():
            if time.monotonic() > give_up:
                raise TimeoutError(f"no plan after {MESH_PLAN_WAIT_S} s")
            time.sleep(0.05)
        plan = pickle.loads(plan_path.read_bytes())
        planned_at = time.time()
        device = plan["device"].format(rank=rank)
        if torch.device(device).type == "cuda":
            missing = [n for n in _build.SOURCES
                       if not _build.library_path(n).exists()]
            if missing:
                raise RuntimeError(f"kernels not built by phase_build: "
                                   f"{missing}")
        dev = init_process_group(device, f"file://{out_dir}/rendezvous",
                                 rank=rank,
                                 world_size=world, backend=plan["backend"],
                                 timeout_s=plan["timeout_s"])
        counters = _kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        result = {"rank": rank, "device": str(dev),
                  "backend": dist.get_backend(),
                  "entered_at": entered_at, "imported_at": imported_at,
                  "planned_at": planned_at, "joined_at": time.time()}
        for job in plan["jobs"]:
            t0 = time.perf_counter()
            result[job] = _MESH_JOBS[job](plan, dev)
            result[job]["job_s"] = time.perf_counter() - t0
            # on stderr as each job ends: what a later job's failure hides
            print(json.dumps({"train_mesh_rank": rank, "job": job,
                              **{k: result[job].get(k) for k in (
                                  "job_s", "peak_bytes", "marks", "save",
                                  "step_ms", "comm_ms")}}),
                  file=sys.stderr, flush=True)
            _free(dev)
            dist.barrier()
        result["launches"] = {k: fn.launches for k, fn in counters.items()}
        result["jobs_done_at"] = time.time()
        dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)



def _mesh_axes(world: int) -> dict:
    """The jobs' meshes: at four ranks ``{dp: 2, tp: 2}``, ``{dp: 2, pp:
    2}``, ``{dp: 2, ep: 2}`` and sp = 4; at two, the same without dp."""
    dp = {"dp": world // 2} if world > 2 else {}
    return {"a": {**dp, "tp": 2}, "b": {**dp, "pp": 2},
            "c": {**dp, "ep": 2}, "d": {"sp": world}}


def _mesh_reference(dev, cfg, moe_cfg, ring_shape, batch_shape, moe_shape,
                    directory: Path) -> dict:
    """The one-rank references on ``dev``, without a process group (every
    collective the identity), from the weights of seed 0 and JAX's
    default optimizer: (a) ``MESH_STEPS`` steps on the ``batch_shape``
    batch (``_train_batch``), their gradient norms and step 1's
    gradients (saved in ``directory``); (b) ``MESH_PIPE_STEPS`` steps on
    twice its rows ((a)'s and as many more: M microbatches over dp = 2
    need 2 M rows); (c) the MoE model's steps and step 1's gradients;
    (d) plain causal attention over the whole sequence in float32, a
    chunk of heads at a time: its output and the input gradients of a
    random output gradient (``ring.npz``). Returns the losses, norms,
    step ms and the batches (numpy) for the ranks."""
    import numpy as np
    import torch
    from gofr_tpu_torch.checkpoint import Checkpointer, flatten
    from gofr_tpu_torch.models.moe import moe_init, moe_prefill
    from gofr_tpu_torch.ops.attention import xla_attention
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import moe_param_specs
    from gofr_tpu_torch.parallel.train import (default_optimizer,
                                               make_train_state,
                                               make_train_step)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def run(config, steps, batch, grads_dir=None, moe=False):
        mesh = create_mesh({"dp": 1}, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        opt, seen = _capturing(default_optimizer())
        kw = {"init_fn": moe_init, "specs_fn": moe_param_specs} if moe \
            else {}
        state, _ = make_train_state(gen, config, mesh, optimizer=opt, **kw)
        shapes = {key: list(x.shape) for key, x in flatten(state.params)}
        fwd = (lambda p, t: moe_prefill(p, t, config,
                                        implementation="plain")[0]) \
            if moe else None
        step = make_train_step(config, mesh, optimizer=opt, forward_fn=fwd,
                               donate=False)
        losses, norms, ms = [], [], []
        for i in range(steps):
            sync()
            t0 = time.perf_counter()
            state, loss = step(state, *batch)
            losses.append(float(loss))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(step.grad_norm))
            if i == 0 and grads_dir is not None:
                t1 = time.perf_counter()
                Checkpointer(grads_dir).save(1, seen[0])
                save_s = time.perf_counter() - t1
            seen[0] = None
        del state, step
        _free(dev)
        return {"losses": losses, "grad_norms": norms, "step_ms": ms,
                "shapes": shapes, "grads_save_s": save_s if grads_dir
                else None}

    out: dict = {}
    batch = _train_batch(cfg, dev, *batch_shape)
    out["a"] = run(cfg, MESH_STEPS, batch, directory / "dense_grads")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows, seq = batch_shape
    more = torch.randint(0, cfg.vocab_size, (rows, seq + 1), generator=gen,
                         device=dev)
    pipe = [torch.cat([batch[0], more[:, :-1]]),
            torch.cat([batch[1], more[:, 1:]]),
            torch.cat([batch[2], torch.ones_like(batch[2])])]
    out["b"] = run(cfg, MESH_PIPE_STEPS, pipe)
    moe_batch = _train_batch(moe_cfg, dev, *moe_shape)
    out["c"] = run(moe_cfg, MESH_MOE_STEPS, moe_batch,
                   directory / "moe_grads", moe=True)
    out["c"]["halves_losses"] = _dp_halves_losses(dev, moe_cfg, moe_batch)
    out["batch"], out["pipe_batch"], out["moe_batch"] = (
        [x.cpu().numpy() for x in b] for b in (batch, pipe, moe_batch))
    del batch, pipe, more, moe_batch
    _free(dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q, k, v, do = (torch.randn(ring_shape, generator=gen, device=dev)
                   for _ in range(4))
    want = {n: torch.empty_like(q) for n in ("out", "dq", "dk", "dv")}
    chunk = min(8, ring_shape[2])
    sync()
    t0 = time.perf_counter()
    for h in range(0, ring_shape[2], chunk):
        heads = slice(h, h + chunk)
        qc, kc, vc = (t[:, :, heads].clone().requires_grad_()
                      for t in (q, k, v))
        oc = xla_attention(qc, kc, vc, causal=True)
        grads = torch.autograd.grad(oc, (qc, kc, vc), do[:, :, heads])
        for n, t in zip(("out", "dq", "dk", "dv"), (oc.detach(), *grads)):
            want[n][:, :, heads] = t
        del qc, kc, vc, oc, grads
    sync()
    out["d"] = {"plain_ms": (time.perf_counter() - t0) * 1e3}
    np.savez(directory / "ring.npz", q=q.cpu().numpy(), k=k.cpu().numpy(),
             v=v.cpu().numpy(), do=do.cpu().numpy(),
             **{n: t.cpu().numpy() for n, t in want.items()})
    del q, k, v, do, want
    _free(dev)
    return out


def _dp_halves_losses(dev, c, batch) -> list:
    """The MoE model's one-rank steps with the gradient summed in bf16
    from the batch's two halves, each half's taken over the whole
    batch's count (half of its own, exactly: a power of two), as two
    dp ranks sum theirs: the one-rank step with the mesh's dp
    roundings, and no collective. The losses of ``MESH_MOE_STEPS``
    steps."""
    import torch
    from gofr_tpu_torch.models.moe import moe_init, moe_prefill
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import moe_param_specs
    from gofr_tpu_torch.parallel.train import (TrainState, _map,
                                               apply_updates,
                                               default_optimizer,
                                               global_norm, make_train_state,
                                               make_train_step)
    mesh = create_mesh({"dp": 1}, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, opt = make_train_state(gen, c, mesh, init_fn=moe_init,
                                  specs_fn=moe_param_specs)
    step = make_train_step(c, mesh, donate=False, forward_fn=lambda p, t:
                           moe_prefill(p, t, c, implementation="plain")[0])
    rows = batch[0].shape[0] // 2
    halves = [[x[:rows] for x in batch], [x[rows:] for x in batch]]
    losses = []
    for _ in range(MESH_MOE_STEPS):
        (la, ga), (lb, gb) = (step.loss_and_grads(state.params, *h)
                              for h in halves)
        losses.append((float(la) + float(lb)) / 2)
        grads = _map(lambda a, b: a / 2 + b / 2, ga, gb)
        del ga, gb
        updates, opt_state = opt.update(grads, state.opt_state, state.params,
                                        g_norm=global_norm(grads))
        del grads
        state = TrainState(params=apply_updates(state.params, updates),
                           opt_state=opt_state, step=state.step + 1)
        del updates, opt_state
    del state
    _free(dev)
    return losses


def _by_dp(ranks: list) -> dict:
    """The ranks of each dp replica (ranks whose ``coords`` share dp)."""
    out: dict = {}
    for r in ranks:
        out.setdefault(r["coords"].get("dp", 0), []).append(r)
    return out


def _cos_faults_of(records: list) -> tuple[list, float]:
    """From the ``_grad_record`` of every rank of a job (each with its
    ``coords``): per dp replica, each group's cosine against the
    reference, its parts summed over the ranks that hold one (a group
    every rank holds whole taken once); faults below ``TRAIN_GRAD_COS``,
    and the least cosine."""
    faults, least = [], 1.0
    for d, group in _by_dp(records).items():
        sums: dict = {}
        for r in group:
            for label, (dot, na, nb, whole) in r["parts"].items():
                if whole and label in sums:
                    continue
                acc = sums.setdefault(label, [0.0, 0.0, 0.0])
                for i, x in enumerate((dot, na, nb)):
                    acc[i] += x
        for label, (dot, na, nb) in sums.items():
            cos = (1.0 if na == nb == 0.0 else
                   dot / math.sqrt(na * nb) if na * nb > 0 else 0.0)
            least = min(least, cos)
            if not cos >= TRAIN_GRAD_COS:
                faults.append(f"dp {d} {label} cos {cos:.5f}")
    return faults, least


def _replica_faults(label: str, ranks: list, digests) -> list:
    """Ranks of different dp replicas at one place on the other axes
    must hold bit-equal leaves (``digests(rank) -> {key: sha1}``)."""
    seen: dict = {}
    faults = []
    for r in ranks:
        place = tuple(sorted((k, v) for k, v in r["coords"].items()
                             if k != "dp"))
        got = digests(r)
        if place in seen and seen[place] != got:
            differ = [k for k in got if got[k] != seen[place].get(k)]
            faults.append(f"{label}: dp replicas at {dict(place)} differ "
                          f"in {len(differ)} leaves, {differ[:2]}")
        seen.setdefault(place, got)
    return faults


def _loss_faults(label: str, got: list, want: list,
                 tols: list | None = None) -> list:
    """Each step's loss within ``TRAIN_LOSS_TOL`` of the reference's (or
    within that step's tolerance of ``tols``)."""
    if len(got) != len(want):
        return [f"{label}: {len(got)} losses for {len(want)}"]
    tols = tols or [TRAIN_LOSS_TOL] * len(want)
    return [f"{label} step {i + 1} loss {g} vs {w} (tolerance {t})"
            for i, (g, w, t) in enumerate(zip(got, want, tols))
            if not abs(g - w) <= t]


def _moe_loss_tols(ref: dict) -> list:
    """(c)'s tolerance at each step against the one-rank step:
    ``TRAIN_LOSS_TOL``, or ``MESH_MOE_SPREAD`` times the distance between
    the one-rank step and the same step with the mesh's dp roundings
    (``_dp_halves_losses``), where that is wider. The dp sum adds two
    bf16 gradients, each rounded once already; after the first update a
    router weight whose gradient sign those roundings turn sends a token
    near a tie of its top two to the other expert, and the loss moves by
    a discrete step."""
    return [max(TRAIN_LOSS_TOL, MESH_MOE_SPREAD * abs(a - b))
            for a, b in zip(ref["losses"], ref["halves_losses"])]


def _step1_faults(label: str, runs: list, want_loss: float) -> list:
    """Step 1's loss, gradients against the reference's and dp replicas
    bit-equal, over every rank's record of one run (``loss``, ``parts``,
    ``digests``, ``coords``)."""
    faults = []
    for r in runs:
        faults += _loss_faults(f"{label} rank {r['coords']}", [r["loss"]],
                               [want_loss])
    faults += _cos_faults_of(runs)[0]
    return faults + _replica_faults(label, runs, lambda r: r["digests"])


def _shape_faults(ranks: list, shapes: dict, axes: dict) -> list:
    """Each rank holds one part of every leaf per mesh axis its spec
    names (``shard_params``), the whole leaf along the others."""
    faults = []
    for r in ranks:
        for key, (local, spec) in r["a"]["shapes"].items():
            want = [n // (axes.get(a, 1) if a else 1)
                    for n, a in zip(shapes[key], list(spec) + [None] * 8)]
            if local != want:
                faults.append(f"rank {r['rank']} {key} {local}, "
                              f"want {want}")
    return faults


def _mesh_checks(ranks: list, ref: dict, plan: dict) -> tuple[dict, dict]:
    """(failed, planted): per check, the faults of the run; per planted
    fault, the faults the same checks found in its run (each must find
    one)."""
    failed: dict = {}
    planted: dict = {}
    jobs = plan["jobs"]
    axes = plan["axes"]
    if "a" in jobs:
        a = [dict(r["a"], rank=r["rank"]) for r in ranks]
        want = ref["a"]
        f = []
        for r in a:
            f += _loss_faults(f"rank {r['rank']}", r["losses"],
                              want["losses"])
            f += [f"rank {r['rank']} step {i + 1} gradient norm {g} vs {w}"
                  for i, (g, w) in enumerate(zip(r["grad_norms"],
                                                 want["grad_norms"]))
                  if not abs(g - w) <= MESH_NORM_RTOL * w]
        f += _step1_faults("a", [dict(r["grads"], coords=r["coords"],
                                      loss=r["losses"][0]) for r in a],
                           want["losses"][0])
        f += _replica_faults("a params", a, lambda r: r["param_digests"])
        f += _shape_faults(ranks, want["shapes"], axes["a"])
        f += _fall_faults(a[0]["losses"], a[0]["grad_norms"])
        launched = {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
        if any(launched.values()):
            f.append(f"the trainer launched {launched}")
        failed["a"] = f
        plants = [("a_wo_swapped", "planted_wo")]
        if axes["a"].get("dp", 1) > 1:      # without dp there is no sum
            plants.append(("a_dp_sum_skipped", "planted_dp"))
        for name, key in plants:
            planted[name] = _step1_faults(
                name, [dict(r[key], coords=r["coords"]) for r in a],
                want["losses"][0])
        if plan["resume"]:
            for name, key in (("e", "e"), ("e_wrong_moment", "e_planted")):
                f = []
                for r in a:
                    run = r[key]
                    if run["n_differ"]:
                        f.append(f"rank {r['rank']}: {run['n_differ']} "
                                 f"leaves differ, {run['differ']}")
                    if run["losses"] != r["losses"][2:4]:
                        f.append(f"rank {r['rank']}: losses {run['losses']}"
                                 f" vs {r['losses'][2:4]}")
                (failed if name == "e" else planted)[name] = f
    if "b" in jobs:
        b = [r["b"] for r in ranks]
        f = []
        for r in b:
            f += _loss_faults(f"b {r['coords']}", r["losses"],
                              ref["b"]["losses"])
            if r["layers"] != plan["cfg"].n_layers // axes["b"]["pp"]:
                f.append(f"b {r['coords']} holds {r['layers']} layers")
        failed["b"] = f
        planted["b_previous_activation"] = sum(
            (_loss_faults(f"b {r['coords']}", [r["planted"]["loss"]],
                          ref["b"]["losses"][:1]) for r in b), [])
    if "c" in jobs:
        c = [r["c"] for r in ranks]
        f = []
        tols = _moe_loss_tols(ref["c"])
        for r in c:
            f += _loss_faults(f"c {r['coords']}", r["losses"],
                              ref["c"]["losses"], tols)
            f += _loss_faults(f"c {r['coords']} (the dp-halves step)",
                              r["losses"], ref["c"]["halves_losses"])
            if r["experts"] != plan["moe_cfg"].n_experts // axes["c"]["ep"]:
                f.append(f"c {r['coords']} holds {r['experts']} experts")
        f += _step1_faults("c", [dict(r["grads"], coords=r["coords"],
                                      loss=r["losses"][0]) for r in c],
                           ref["c"]["losses"][0])
        failed["c"] = f
        planted["c_first_expert_off"] = _step1_faults(
            "c planted", [dict(r["planted"], coords=r["coords"])
                          for r in c], ref["c"]["losses"][0])
    if "d" in jobs:
        def ring_faults(key):
            return [f"d {r['d']['coords']} {n} error {e:.3g} of the "
                    f"largest |value|" for r in ranks
                    for n, e in r["d"][key].items()
                    if not e <= MESH_RING_TOL]

        failed["d"] = ring_faults("err")
        planted["d_diagonal_full"] = ring_faults("planted_diagonal")
        if axes["d"]["sp"] > 2:     # at two ranks either way is one swap
            planted["d_hop_reversed"] = ring_faults("planted_hop")
    return failed, planted


def _run_ranks(world: int, make_plan, deadline_s: float) -> tuple:
    """Spawn ``world`` rank processes of ``_mesh_rank``, then call
    ``make_plan()`` (the parent's reference work: the ranks start up
    meanwhile, ~14 s beside the H100) and hand its plan to them;
    join them against one deadline. (every rank's results, the plan, the
    spawn's wall time), or an error naming the ranks that failed (each
    rank still alive is killed, also when ``make_plan`` raises)."""
    import json
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    out_dir = tempfile.TemporaryDirectory(prefix="gofr_mesh_ranks_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank,
                             args=(r, world, str(ROOT), out_dir.name))
                 for r in range(world)]
        spawned_at = time.time()
        for p in procs:
            p.start()
        try:
            plan = make_plan()
            staged = Path(out_dir.name, "plan.tmp")
            staged.write_bytes(pickle.dumps(plan))
            staged.rename(Path(out_dir.name, "plan.pkl"))
            end = time.monotonic() + deadline_s
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        errors = {r: Path(out_dir.name, f"rank{r}.err").read_text()
                  for r in range(world)
                  if Path(out_dir.name, f"rank{r}.err").exists()}
        if errors or any(p.exitcode != 0 for p in procs):
            raise AssertionError(
                f"train_mesh: a rank failed (exit codes "
                f"{[p.exitcode for p in procs]}):\n"
                + "\n".join(f"--- rank {r}\n{e}"
                            for r, e in sorted(errors.items())))
        return ([json.loads(Path(out_dir.name, f"rank{r}.json").read_text())
                 for r in range(world)], plan, spawned_at)
    finally:
        out_dir.cleanup()


def _median(xs: list):
    return statistics.median(xs) if xs else None


def _mesh_figures(ranks: list, ref: dict, plan: dict, tokens: dict) -> dict:
    """Per job: step ms (median of every step but the first) and
    tokens/s, rank 0's collective ms a step, each rank's peak GB, the
    one-rank reference's step ms; (e)'s save and restore seconds; the
    ring's fwd + bwd ms."""
    figs: dict = {}
    for job in ("a", "b", "c"):
        if job not in plan["jobs"]:
            continue
        lead = ranks[0][job]
        step_ms = _median(lead["step_ms"][1:])
        figs[job] = {
            "step_ms": lead["step_ms"], "step_ms_median": step_ms,
            "tokens_per_s": tokens[job] / (step_ms / 1e3),
            "comm_ms": lead["comm_ms"],
            "comm_ms_median": _median(lead["comm_ms"][1:]),
            "one_rank_dp_halves_losses": ref[job].get("halves_losses"),
            "peak_gb": [r[job]["peak_bytes"] / 2 ** 30
                        if r[job]["peak_bytes"] is not None else None
                        for r in ranks],
            "job_s": [r[job]["job_s"] for r in ranks],
            "one_rank_step_ms": ref[job]["step_ms"],
            "one_rank_step_ms_median": _median(ref[job]["step_ms"][1:]),
            "losses": lead["losses"], "one_rank_losses": ref[job]["losses"]}
    if "a" in plan["jobs"]:
        figs["a"]["grad_norms"] = ranks[0]["a"]["grad_norms"]
        figs["a"]["one_rank_grad_norms"] = ref["a"]["grad_norms"]
        if plan["resume"]:
            figs["e"] = {"save": ranks[0]["a"]["save"],
                         "restore_s": [r["a"]["e"]["restore_s"]
                                       for r in ranks]}
    if "d" in plan["jobs"]:
        lead = ranks[0]["d"]
        figs["d"] = {"ms": lead["ms"], "comm_ms": lead["comm_ms"],
                     "err": lead["err"], "plain_one_rank_ms":
                         ref["d"]["plain_ms"],
                     "peak_gb": [r["d"]["peak_bytes"] / 2 ** 30
                                 if r["d"]["peak_bytes"] is not None
                                 else None for r in ranks],
                     "job_s": [r["d"]["job_s"] for r in ranks]}
    return figs


def phase_train_mesh(dev, smi_line: str, **kw) -> dict:
    """``train_mesh_run`` (its docstring), raising when a check failed or
    a planted fault passed."""
    out = train_mesh_run(dev, smi_line, **kw)
    bad = {k: v for k, v in out["failed_checks"].items() if v}
    missed = [k for k, v in out["planted"].items() if not v]
    if bad or missed:
        raise AssertionError(f"train_mesh: failed checks {bad}, planted "
                             f"faults that passed: {missed}")
    return out


def train_mesh_run(dev, smi_line: str, cfg=None, moe_cfg=None,
                   ring_shape=MESH_RING_SHAPE,
                   batch_shape=(TRAIN_B, TRAIN_S),
                   moe_shape=(MESH_MOE_B, MESH_MOE_S),
                   deadline_s: float = 900.0) -> dict:
    """The trainer on a mesh (``gofr_tpu_torch/parallel/``): four rank
    processes sharing the card over ``gloo`` (every collective of a CUDA
    tensor staged through the host, ``comm.py``), each job on a mesh of
    its own and held against the port's one-rank step on the card (the
    same weights from seed 0, the same batch, JAX's default optimizer),
    which this process computes first (``_mesh_reference``) and hands
    to the ranks as numpy before it frees the card:

    (a) ``llama3_1b`` uncut, bf16, ``{dp: 2, tp: 2}``, train_llama's
        fixed 4 x 512 batch, ``MESH_STEPS`` steps under deterministic
        algorithms: every step's loss within ``TRAIN_LOSS_TOL`` and
        gradient norm within ``MESH_NORM_RTOL`` of the reference's; step
        1's gradients, gathered from the tp shards, at cosine >=
        ``TRAIN_GRAD_COS`` for every layer's matrices and norms, the
        embedding and the final norm; dp replicas bit-equal; each rank
        one tp-th of every sharded leaf; the loss falls; no kernel of the
        repository launched. Planted: one rank's ``wo`` block its tp
        peer's; the dp gradient sum skipped on one rank.
    (b) the same model, GPipe at ``{dp: 2, pp: 2}``, M = ``MESH_PIPE_M``,
        8 layers a stage, on 8 x 512 rows ((a)'s 4 and 4 more: M
        microbatches over dp = 2 need 2 M rows), ``MESH_PIPE_STEPS``
        steps: losses within ``TRAIN_LOSS_TOL`` of the reference's on
        those rows. Planted: stage 0 of one replica sends the previous
        microbatch's activation.
    (c) ``MoEConfig.mixtral_8x7b()`` width, 1 of its 32 layers, bf16,
        ``{dp: 2, ep: 2}``, 4 x 256 tokens, ``MESH_MOE_STEPS`` steps:
        losses within ``TRAIN_LOSS_TOL``, or within ``MESH_MOE_SPREAD``
        times the distance between the one-rank step and the same step
        with the mesh's dp roundings where that is wider
        (``_moe_loss_tols``), and within ``TRAIN_LOSS_TOL`` of that
        step's (``_dp_halves_losses``); step 1's
        gradients (every expert, gathered over ep) at cosine >=
        ``TRAIN_GRAD_COS``; dp replicas bit-equal. Planted:
        ``ExpertShard.first`` one expert off on one rank.
    (d) ``make_ring_attention`` at sp = 4, q / k / v
        ``MESH_RING_SHAPE`` float32: the output and the three input
        gradients (of a random output gradient) against plain causal
        attention on one rank, within ``MESH_RING_TOL`` of each tensor's
        largest magnitude. Planted: the diagonal block run as a full
        block; the first hop rotated the wrong way.
    (e) (a)'s ranks: the state saved whole after step 2 through
        ``Checkpointer`` (the dp = 0 ranks gather it onto the host, rank
        0 writes), each rank's slices restored with ``sharding_fn``,
        steps 3-4 again: parameters, moments, ``count``, ``step`` and
        losses bit for bit the uninterrupted run's. Planted: one rank's
        restored ``wo`` first moment its tp peer's block.

    Figures (one line per job before the summary): step ms (median of
    every step but the first), tokens/s, the ms a step spends in
    ``comm.py``'s collectives on rank 0 (``_CommTimer``), each rank's
    peak memory, the one-rank step's ms; (e)'s save / restore seconds;
    the phase's wall. ``cfg`` and the shapes: a CPU rehearsal at a small
    size (``tests/test_torch_train_mesh.py``). Returns the summary line
    (its check lists whole) and the figures."""
    import tempfile
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.models.moe import MoEConfig
    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cfg = cfg or LlamaConfig.llama3_1b()
    moe_cfg = moe_cfg or MoEConfig.mixtral_8x7b().scaled(n_layers=1)
    tmp = tempfile.TemporaryDirectory(prefix="gofr_mesh_")
    ref: dict = {}

    def make_plan() -> dict:
        t0 = time.perf_counter()
        ref.update(_mesh_reference(dev, cfg, moe_cfg, ring_shape,
                                   batch_shape, moe_shape, Path(tmp.name)))
        _free(dev)
        ref["reference_s"] = time.perf_counter() - t0
        ref["parent_gb"] = (torch.cuda.memory_reserved(dev) / 2 ** 30
                            if dev.type == "cuda" else None)
        return {"cfg": cfg, "moe_cfg": moe_cfg, "dir": Path(tmp.name),
                "device": str(dev), "backend": "gloo",
                "timeout_s": MESH_TIMEOUT_S, "jobs": ["c", "a", "b", "d"],
                "resume": True, "planted_rank": 0,
                "axes": _mesh_axes(MESH_WORLD),
                "batch": ref.pop("batch"), "pipe_batch": ref.pop("pipe_batch"),
                "moe_batch": ref.pop("moe_batch")}

    try:
        t0 = time.perf_counter()
        ranks, plan, spawned_at = _run_ranks(MESH_WORLD, make_plan,
                                             deadline_s)
        ranks_s = time.perf_counter() - t0
        ended_at = time.time()
    finally:
        tmp.cleanup()
    failed, planted = _mesh_checks(ranks, ref, plan)
    rows, seq = batch_shape
    figs = _mesh_figures(ranks, ref, plan,
                         {"a": rows * seq, "b": 2 * rows * seq,
                          "c": moe_shape[0] * moe_shape[1]})
    for job, fig in figs.items():
        emit({"phase": "train_mesh_job", "job": job, "card": smi_line,
              "mesh": plan["axes"].get(job, plan["axes"]["a"]), **fig})
    out = {"phase": "train_mesh", "card": smi_line,
           "model": f"llama3_1b ({cfg.n_layers} layers), "
                    f"mixtral_8x7b width ({moe_cfg.n_layers} layer), "
                    f"ring {list(ring_shape)}",
           "world": MESH_WORLD, "backend": ranks[0]["backend"],
           "devices": [r["device"] for r in ranks],
           "launches": ranks[0]["launches"],
           "tolerances": {"loss": TRAIN_LOSS_TOL, "grad_cos": TRAIN_GRAD_COS,
                          "c_loss": _moe_loss_tols(ref["c"]),
                          "grad_norm_rel": MESH_NORM_RTOL,
                          "fall": TRAIN_FALL, "ring_rel": MESH_RING_TOL},
           "reference_s": ref["reference_s"], "ranks_s": ranks_s,
           "rank_start_s": {k: max(r[f"{k}_at"] for r in ranks) - spawned_at
                            for k in ("entered", "imported", "planned",
                                      "joined")},
           "rank_exit_s": ended_at - max(r["jobs_done_at"] for r in ranks),
           "reference_grads_save_s": [ref[j]["grads_save_s"]
                                      for j in ("a", "c")],
           "parent_reserved_gb": ref["parent_gb"],
           "phase_wall_s": time.perf_counter() - t_phase,
           "failed_checks": failed, "planted": planted}
    emit({**out, **{key: {k: v[:4] + [f"... {len(v) - 4} more"] * (len(v) > 4)
                          for k, v in out[key].items()}
                    for key in ("failed_checks", "planted")}})
    return {**out, "figures": figs}


def main() -> int:
    import os
    # telemetry pings a public host at every app's start and stop: off for
    # the whole run, which has no network (``telemetry.enabled``)
    os.environ["GOFR_TELEMETRY"] = "false"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import gofr_tpu_torch  # noqa: F401 — fails outside the repository
    from gofr_tpu_torch.device import resolve_device
    dev = resolve_device("cuda")
    smi_line, env = phase_env()
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # each paged kernel's check gives its bf16 row, then its int8 row
    paged = [kernel_paged(dev, gen, [0, 1, 63, 64, 65, 1500, 300, 1000], 2,
                          "B=8 Hq=32 Hkv=8 hd=64 pg=64 Np=256, lengths "
                          "0/1/63/64/65/1500/300/1000, OOB-padded tables,"),
             kernel_chunk(dev, gen),
             kernel_tree(dev, gen, _tree_slots(), 4,
                         "B=8 W=16 Hq=32 Hkv=8 hd=64 pg=64 Np=256 Mp=32, "
                         "histories 0/1/63/64/65/1500/300/1000", 3)]
    rows = [kernel_flash(dev, gen)] + [r[0] for r in paged] \
        + [r[1] for r in paged]
    # wave 1's widest prefill bucket, and the chunk kernel at GQA group 3
    rows += [kernel_flash(dev, gen, wide=True),
             kernel_chunk(dev, gen, group3=True)[0]]
    # the KV write kernel, both pool forms (its own generator: the rows
    # below draw the same inputs as before it was added)
    rows += kernel_kv_write(dev, torch.Generator(device=dev).manual_seed(7))
    rows += kernel_kv_write_prefill(dev,
                                    torch.Generator(device=dev).manual_seed(9))
    # head_dim 128 (Mixtral-8x7B): flash and the slab write's view
    # write-back, whose launches come from serve_moe
    rows += [kernel_flash(dev, torch.Generator(device=dev).manual_seed(15),
                          d128=True)]
    rows += kernel_kv_write_view(dev,
                                 torch.Generator(device=dev).manual_seed(16))
    # one rank's shapes of Llama-3-70B at tp = 2 (GQA group 8, head_dim
    # 128, Hkv 4), whose launches come from serve_tp's ranks
    rows += [kernel_flash(dev, torch.Generator(device=dev).manual_seed(24),
                          tp2=True)]
    rows += kernel_kv_write_prefill(
        dev, torch.Generator(device=dev).manual_seed(25), tp2=True)
    # head_dim 128 (Llama-3-8B): the paged kernels, both forms, and the
    # fused RoPE + K/V write, whose launches come from serve_llama8b
    d128 = torch.Generator(device=dev).manual_seed(17)
    paged128 = [
        kernel_paged(dev, d128, [0, 1, 63, 64, 65, 2047, 300, 1000], 2,
                     "B=8 Hq=32 Hkv=8 hd=128 pg=64 Np=256, lengths "
                     "0/1/63/64/65/2047/300/1000, OOB-padded tables,", d=128),
        kernel_chunk(dev, d128, d=128),
        kernel_tree(dev, d128, _tree_slots(), 4,
                    "B=8 W=16 Hq=32 Hkv=8 hd=128 pg=64 Np=256 Mp=32, "
                    "histories 0/1/63/64/65/1500/300/1000", 3, d=128)]
    rows += [r[0] for r in paged128] + [r[1] for r in paged128]
    rows += kernel_rope_kv_write(
        dev, torch.Generator(device=dev).manual_seed(18), False, d=128)
    # the fused RoPE + K/V write at a decode step's and a verify's shape
    for seed, verify in ((13, False), (14, True)):
        rows += kernel_rope_kv_write(
            dev, torch.Generator(device=dev).manual_seed(seed), verify)
    # single-request latency, where split-KV matters most: one slot of
    # 2047 rows in decode, one verify over 1900 history rows; printed as
    # their own kernel lines, checked as the rows above
    kernel_paged(dev, gen, [2047], 5, "B=1 Hq=32 Hkv=8 hd=64 pg=64 Np=256, "
                 "length 2047 (one request),")
    kernel_tree(dev, gen, _tree_slot_b1(), 6,
                "B=1 W=16 Hq=32 Hkv=8 hd=64 pg=64 Np=256 Mp=32, history "
                "1900 (one request)", None)
    # the weight-dequantizing GEMM at llama3_1b's products, both forms
    rows += kernel_wq_gemm(dev, torch.Generator(device=dev).manual_seed(11),
                           smi_line)
    # the head dims and types beside bf16 at 64 / 128, whose launches
    # come from serve_openllama and serve_shapes
    for case in SHAPE_CASES:
        rows += kernel_shapes(dev, *case)
    # GQA groups 32 and 48, cut into sub-groups of 16 heads on the card
    for case in WIDE_GROUP_CASES:
        rows += kernel_shapes(dev, *case, writes=False)
    phase_moe_tie(dev)
    phase_model(dev)
    phase_model_chunk(dev)
    phase_model_spec(dev)
    phase_model_int8(dev)
    phase_model_wq(dev, smi_line)
    phase_decode_graph(dev, smi_line)
    serve = phase_serve(dev, smi_line)
    phase_serve_stream(dev, smi_line)
    phase_serve_obs(dev, smi_line)
    phase_serve_recover(dev, smi_line)
    phase_serve_fleet(dev, smi_line)
    serve_int8 = phase_serve(dev, smi_line, bf16=serve)
    launches = {**serve_int8["launches"], **serve["launches"],
                **phase_serve_spec(dev, smi_line),
                **phase_serve_wq(dev, smi_line)}
    phase_serve_preempt(dev, smi_line)
    phase_checkpoint(dev, smi_line)
    # Llama-3-8B at 4 of its 32 layers and Mixtral-8x7B at 2 since the
    # attention kernels came in every type and head dim (8 and 4 before,
    # 16 and 8 before train_mesh joined the script), to keep the whole
    # run well inside its time limit
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.models.moe import MoEConfig
    sources = {"serve_moe": phase_serve_moe(
                   dev, smi_line,
                   cfg=MoEConfig.mixtral_8x7b().scaled(n_layers=2)),
               "serve_llama8b": phase_serve_llama8b(
                   dev, smi_line,
                   cfg=LlamaConfig.llama3_8b().scaled(n_layers=4))}
    sources["serve_openllama"] = phase_serve_openllama(dev, smi_line)
    sources.update(phase_serve_shapes(dev, smi_line))
    phase_serve_embed(dev, smi_line)
    phase_serve_asr(dev, smi_line)
    phase_serve_warm(dev, smi_line)
    phase_serve_app(dev, smi_line)
    phase_serve_ws(dev, smi_line)
    phase_serve_wire(dev, smi_line)
    phase_serve_stores(dev, smi_line)
    phase_serve_cli(dev, smi_line)
    examples = phase_serve_examples(dev, smi_line)
    phase_train_llama(dev, smi_line)
    sources["serve_tp"] = phase_serve_tp(dev, smi_line)
    phase_train_mesh(dev, smi_line)
    # rows of shapes no phase serves (main_path false) launch nothing there
    sources["none"] = collections.defaultdict(int)
    for row in rows:
        source = sources.get(row.get("launches_from"), launches)
        wrapper = row.get("wrapper", row["name"])
        row["launches"] = source[wrapper]
        # the same wrapper's launches under the model-serving example,
        # bf16 (a) and int8 weights (b), where the row's shapes are its
        if "launches_from" not in row and wrapper in examples["b"]:
            row["serve_examples_launches"] = {
                k: examples[k][wrapper] for k in ("a", "b")
                if wrapper in examples[k]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    # where a row has them: the kernel's own device time beside its
    # call's, the unfused path, whether the main path runs it, its
    # launches under the model-serving example
    extra = ("kernel_device_ms", "unfused_path_ms", "unfused_path_device_ms",
             "main_path", "serve_examples_launches", "kernel_route")
    emit({"kernels": [{k: row[k] for k in keys + extra if k in row}
                      for row in rows]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
