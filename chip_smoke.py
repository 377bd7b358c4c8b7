"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
``ok`` line:

1. build      — compile every CUDA kernel of the port from csrc/ with
                nvcc, one nvcc per source, all started together.
2. kernel     — each kernel against its plain PyTorch version at
                llama3.2-1b shapes (H=32, kvH=8, D=64, bs=16); the main
                case of each is timed beside the plain version, one SDPA
                call over the K/V gathered dense, and the bound:
                ragged (SDPA over the spans padded, each span's keys
                gathered once), caches in q's dtype: decode-only,
                prefill with a prefix hit, a mixed T=256 batch,
                spec-verify spans of 2, 4 and 8 rows, decode at the
                longest context a 64-column table holds (many splits),
                windows that leave whole splits and tile chunks behind,
                spans that end mid-tile next to the next span's rows,
                float32; ragged, int8 caches: the same kinds of case,
                int8 + window + spec among them; both legs at block size
                4 and every head-dim template (16-256, 96 with G = 1, 3,
                16); each bf16 call must launch the tensor-core tile and
                the split path, each f32 call the walk and the split path;
                decode (split-KV + merge): the phase-split run's 4
                lanes (phase 7) at its first, middle and last step,
                timed at the middle one; 8 lanes (contexts 1–600) and an
                idle lane in bf16 and f32, windowed; 1 lane at the
                longest context a 64-column table holds (windows that
                leave whole splits behind); 32 lanes with idle ones
                (2 splits); 40 lanes (1 split, no merge); head dims
                16–256, G = 3 and 16, block size 4; a striped sp=4
                scan (with splits) whose shards' stats merge to the
                unstriped call; each case's (splits, pages) printed;
                prefill (bf16 on the tensor-core entry, f32 on the
                walk): the phase-split run's prefill_batch (4 whole
                prompts padded to T=512), timed; 4 lanes of T=256 with
                prefix hits, padded rows and an idle lane, windowed,
                f32; T=512 behind prefixes that put causal and window
                edges inside chunks; block size 4; every head-dim
                template (16–256, 96) with G = 1, 3, 4, 8, 16; striped
                sp=4.
3. tiny       — tiny-test in float32: 3 concurrent greedy requests through
                TorchEngine.generate equal the port's reference_forward
                continuation on the card; an int8-KV engine keeps a greedy
                match rate >= 0.7 against them; ModelRunner.prefill_batch
                + decode_multi equal reference_forward too.
4. serve      — the main path at full width: a llama3.2-1b TorchEngine in
                bf16 (random weights from a seed) warms up — one CUDA
                graph per program of the warmup plan, 5 budget rungs and
                the extras program, each greedy and sampled; graphs,
                capture seconds and pool bytes reported — then serves 8
                concurrent requests through generate(), every dispatch a
                replay, none captured mid-traffic; the ragged wrapper
                must have launched num_layers times per unified dispatch
                (a replay adds its graph's launches), each call on the
                tensor-core tile and the split path; every
                stream is fed back through the no-cache reference_forward
                (finite logits of shape [T, V]; argmax agreement and the
                log-probability gap of each disagreement reported).
5. profile    — 8 more requests on the same engine under torch.profiler:
                device time by kernel and the device's busy share.
   graphs     — the serve's dispatches (recorded) through two fresh
                runners on its weights: one replays its graphs, one runs
                the eager step body; the sampled tokens of every dispatch
                and, at the end, the K/V bytes outside trash block 0 must
                be identical; then wall, host and device ms per dispatch
                and the busy share of each, pipelined two deep, in turns.
6. serve_int8 — the same 8 requests through an int8-KV engine: the int8
                leg must have launched num_layers times per dispatch,
                on the same paths;
                then its own profile, as in 5, and graphs_int8 (scales
                compared too).
   spec       — speculative_k=4 against 0 on the 8 prompts and 2 of
                repeated n-grams, in float32 (streams byte-identical) and
                in bf16 (both engines' streams held to the no-cache
                reference: greedy batching differs, so bf16 ties may fall
                either way); drafts and accepted drafts (> 0), tokens per
                step, verify spans of 2-5 rows, every ragged call on its
                dtype's paths.
7. http       — the OpenAI server at full width, built in process through
                the CLI's own path (``run --out torch --model-path
                preset:llama3.2-1b``, the serve's engine settings) with a
                Tap on each request's engine token ids: 8 concurrent
                streaming /v1/completions of the serve's prompts (token
                ids, 32 tokens, greedy, ignore_eos), 2 aggregated chat
                completions, /v1/models, /health, /metrics. Every reply
                200; usage and the Tap count 32 tokens with finish
                "length"; the streamed text is the toy tokenizer's
                incremental decode of the tapped ids; the ragged wrapper
                launched num_layers times per dispatch on the tile and
                split paths; the tapped streams pass the teacher-forced
                gates of phase 8. Client-side TTFT, ITL (from SSE arrival
                times) and tokens/s beside the serve's; /metrics carries
                the capture gauges. Then extras: for 2 more prompts a
                completion with logprobs and the same with penalties, and
                a chat with top_logprobs (the top-rung extras program):
                each chosen-token logprob within FIRST_LOGPROB_TOL of the
                no-cache reference's (penalized reference for the
                penalized ones), the streams through its teacher-forced
                gates, a penalized stream unlike its plain one. Then a drain with
                one request in flight (it completes; a new request gets
                503), and one ``run --in batch:FILE`` subprocess whose
                JSON report is parsed.
   observe    — the OpenAI server again (the CLI's own path, the serve's
                settings, quantum 256), with the tracer writing a JSONL
                capture, the flight recorder on and a profile directory.
                Server A, ``--coloc static``: 4 interactive streams (64-token
                prompts, 192 greedy tokens) give the decode ITL p50 at the
                client and the controller's ITL EMA; itl_slo_ms = 1.5 × the
                EMA, printed with both; the same streams
                again with a burst of 4 batch prompts of 896 tokens (8
                tokens each) sent mid-decode; then the serve profile's wall
                ms per dispatch with the tracer and the flight recorder on
                and swapped for no-op stand-ins, in turns. Server B,
                ``--coloc adaptive --itl-slo-ms`` that SLO: the same burst
                leg. Server C, an SLO 10% above the decode-only EMA (at
                1.5× the H100's 256-row dispatch may never pressure the
                controller; this one does): the same leg; then, under the
                same traffic, a request with
                ``X-Request-Timeout-Ms: 1`` sent while the burst holds every
                slot, and a /debug/profile?seconds=1 window (16-token
                requests keep coming until it closes). Reported: client
                ITL p50/p95 over each burst, the quantum trajectory from
                /debug/steps, itl_slo_violations_total. Gates: every reply
                200, full-length streams held to the no-cache reference as
                in phase 8; no capture mid-traffic; on every leg the
                quantum starts at 256, never goes below 16, stays put on
                the static leg, and on an adaptive leg falls only after
                its itl_slo_violations_total rose (a 2 ms poll of the
                controller; the compose-time EMA peak is reported); the
                tight leg's must fall; one flight
                record per unified dispatch; the 1 ms request, sent once
                every slot is running, answers 504 and
                deadline_exceeded_total grows by one; the profile's
                Chrome trace names the ragged kernel; /metrics carries the
                new counters and the trace histograms; the port's
                trace_merge --assert-complete passes on the capture; the
                ragged wrapper launched 16 × the phase's dispatches.
8. phases     — the phase-split entry points at full width on the serve's
                weights: prefill_batch of 4 prompts (64–512 tokens), then
                decode_multi of 32 steps; the prefill kernel launches
                num_layers times per call, all on the tensor-core entry,
                the decode wrapper num_layers times per step; the
                streams fed back through the no-cache
                reference_forward must agree with its argmax (where they
                do not, as near ties), and prefill_batch's first-token
                log-probabilities must match it; token-match rate
                against the unified serve.
   files      — serving from files, on the serve's llama3.2-1b weights:
                they are written as an HF checkout (bf16, two safetensors
                shards with their index, config.json with Llama-3.2's
                rope_scaling, a tokenizer.json whose byte-level BPE is
                learned here from a fixed text with Llama-3's Split
                pattern and special tokens, a Llama-3-style Jinja chat
                template, a generation_config.json with two eos ids),
                read back with ``LocalModel.prepare`` and ``load_params``
                on the card (bytes, seconds, GB/s): the config and every
                weight equal the serve's, and the 8 prompts served from
                the files give the streams of the same weights given in
                memory, both engines holding admission while their
                warmup runs and retiring each dispatch before the next, so
                they dispatch the same batches (the serve phase's
                arrivals race, so its streams are only compared);
                ``run --in http --out torch --model-path DIR`` through the
                CLI's own path serves the first prompt alone to the
                stream the in-memory engine gives it alone.
                A worker process ``run --in dyn://... --model-path DIR
                --config FILE.yaml --set Run.model-name=...`` and the
                CLI's frontend (``--in http --out dyn``) after the
                worker's directory is removed: the frontend materializes
                the shipped tokenizer files; 2 chats, each sent once to
                fill the prefix cache, then aggregated and streamed:
                prompt ids = the port's HfTokenizer's, usage counts them,
                text = decode of the tapped ids = the streamed pieces
                joined; the YAML's max-model-len and the --set name read
                back from the worker's card; the worker's ragged launches
                per dispatch on the tile and split paths. A GGUF (F16, 2
                layers, the whole vocabulary embedded) and an F16
                safetensors checkout of the same weights load equal and
                serve equal streams, ``--model-path FILE.gguf`` over HTTP
                too. DeepSeek-V2-Lite at full width and 2
                layers (dense, then MoE) through the 576-wide ragged
                entry, float32 and bf16 checkouts against the same
                weights as a parameter tree: weights equal, streams equal
                (bf16: or within MLA_BF16_LIMITS' dense leg against the
                no-cache reference).
   wquant     — weight quantization (the wq_gemm kernel, after files).
                Kernel cases: int8 and e4m3 weights quantized on the card,
                bf16 activations of T = 1, 16, 64, 256 rows at
                llama3.2-1b's and llama3-8b's q, k/v, o, gate/up, down,
                tied and untied heads, and of T = 17, 65, 200 at
                llama3.2-1b's q and tied head; deepseek-v2-lite's 64 stacked
                experts (4 and 48 rows each), the split_bmm hi/lo rows and
                MLA's strided per-head w_uk / w_uv at (16, 128, 512);
                float32 activations (the SIMT entry) at one shape each:
                each within KERNEL_TOL (relative to the output's largest
                magnitude) of the plain version and timed beside it, the
                bound and one cuBLAS bf16 product on the unquantized
                weight (each case's plan, kernel/library ratio and share
                of the bound printed); two launches on the same inputs
                give equal bytes (a decode and a rows product that split
                K, a rows product that does not). llama3.2-1b at full
                width under int8, fp8, attn=int8,mlp=fp8 and int8 with
                int8 KV (the serve's draws
                quantized as drawn): phase 8's gates against the no-cache
                reference on the same quantized tree, as many graphs as
                the bf16 serve and none mid-traffic, wq_gemm launched (per
                entry: decode, rows, f32; int8's rows entry too) and the
                plain arm never, the three gauges; tok/s, TTFT p50,
                profiled device ms per dispatch, resident weight bytes and
                the greedy match against the bf16 serve's streams. The
                OpenAI server (``run --weight-quant int8``) answers a chat
                with the gauges on /metrics; the files phase's bf16
                checkout quantizes as it loads to the drawn int8 tree
                (peak device bytes of the load). llama3-8b (32 layers)
                bf16 and int8, held to WQ_8B_LIMITS (int8's rows entry
                launched): device ms per dispatch beside the weight pass's
                bound, each init's peak. deepseek-v2-lite at 2 layers,
                int8, float32 (the SIMT entry) and bf16, under phase 8's
                gates. Wall time at most WQ_BUDGET_S.
9. fleet      — the runtime plane at full width, through the CLI's own
                paths: a ``control-plane --port 0`` process; the frontend
                ``run --in http --out dyn --control-plane ADDR`` built in
                this process (as the http phase builds its server) with a
                Tap on the token ids and serving worker the router
                delivers; worker processes ``run --in
                dyn://dynamo.torch.generate --out torch --model-path
                preset:llama3.2-1b`` with the serve's engine settings and
                a ``--health-port``, each warmed up (its CUDA graphs
                captured) before it serves and registers. Legs: serve — two
                bf16 workers; 8 concurrent streaming /v1/completions of
                the serve's prompts (token ids, 32 greedy tokens,
                ignore_eos): every reply 200, usage and the Tap count 32
                tokens with finish "length", round robin splits them 4
                and 4 (each worker's /metrics), the streams pass phase
                8's teacher-forced gates; token-match rate against the
                http phase's streams; kv_route — a second in-process
                frontend with ``--router-mode kv`` on the same two
                workers: 4 groups × 3 requests, each group sharing a
                384-token prefix (24 blocks), each request its own
                64-token suffix (prompts from the seed), 32 greedy tokens;
                each group's first request, then (the router's indexer
                settled: nothing pending, radix size steady) the 8 later
                ones at once: every later request on its group's first
                worker; 12 route records at /debug/routes, overlap 0 on
                the firsts and 24 on the later ones; the workers'
                kv_reused_device_blocks_total +192; the route-audit join
                (tools/route_audit.py) of the router's records with the
                workers' actual-reuse records off the hit-rate plane
                exact; the router's metrics not stale; the streams
                through phase 8's teacher-forced gates. Then the same
                traffic shape (fresh prefixes) through the round-robin
                frontend, reported only (reuse, TTFT p50); one more
                group through a ``router`` subprocess (RouterService:
                all 3 on one worker, 48 blocks reused, the streams
                through the teacher-forced gates); a ``metrics``
                subprocess's /metrics carries both workers' reuse
                gauges; both subprocesses exit 0 on SIGTERM; and the
                pinned host→device copy rate of 64 KV blocks (the
                router's default_link_gbps) is measured; drain verb —
                one 256-token stream in
                flight on a worker, ``request_drain`` on its lease: the
                stream completes, the instance key is deleted, the next
                request is served by the other worker, the drained worker
                prints "drain complete" and exits 0; SIGTERM — the same on
                the last worker (the request after it finds no worker:
                404 or 503); each drained worker's report line: its ragged
                wrapper launched num_layers times per dispatch, every call
                on the tile and split paths, and its peak device memory;
                failover — two float32 workers: one 4-token prompt for 64
                greedy tokens served uninterrupted, then again, SIGKILL
                to the serving worker once 8 tokens reached the client:
                the stream ends with 64 tokens, finish "length",
                byte-identical to the uninterrupted one, FailoverStats
                counts one WorkerDiedError success, the survivor drains
                on SIGTERM (walk and split paths) and exits 0. Reported:
                worker startup (spawn → "worker serving") and discovery
                (spawn → the instance key's PUT at a watch), client TTFT,
                ITL (p50, p95, and per serving worker) and tok/s beside
                the http phase's, the gap at the client across the kill.
                Every process has its own timeouts and is killed at the
                end of the phase, whatever happened.

10. disagg    — disaggregated prefill/decode and the KVBM tiers on
                llama3.2-1b (max_model_len 2048), with the phase's own
                prompts from seeds: per leg 4 long prompts (1024–1536
                tokens) that go remote (DisaggConfig(max_local_prefill_
                length=512)) and 4 short ones (64–256) that stay local,
                32 greedy tokens each. Legs: device — a decode and a
                prefill engine in this process, the device channel (the
                same prompts served locally first, for the TTFT they
                are compared with); kvbm — an engine with a
                KvBlockManager (a G2 host tier, a G3 disk tier in a
                temporary directory): 8 prompts sharing two 512-token
                prefixes cold, then the device cache cleared and served
                again twice (the adaptive gate's first decisions, then
                with its estimates), the onboarded blocks read back from
                the device cache equal the offered rows by CRC, then G2
                spilled and two touches that promote from G3 (envelope
                verified, no integrity failure); g4 — the G4 peer tier
                between three llama3.2-1b engines, each with its own G2
                and its own runtime on the phase's control plane: engine
                A serves 8 prompts sharing two 512-token prefixes cold
                and exports its G2 (PeerBlockServer); (a) cold engine B,
                a PeerBlockClient attached, parks each prompt on a pull,
                onboards the rows and serves — B's landed rows carry A's
                CRCs, its device blocks read back equal them, its
                kv_actual peer blocks sum to kv_reused_peer_blocks_total,
                pulls >= 1, no fallback, the ragged kernel launched per
                dispatch, no graph captured mid-traffic, streams through
                phase 8's gates; reported: parked TTFT p50 against the
                same prompts recomputed on B, the pull's GB/s, the first
                plan's priced pull against the measured transfer, and the
                plan's decision for a fresh prefix once the measured rate
                is in; (b) a PrefixHeat fed by A's prompts pre-places the
                hottest chains into cold engine C before it serves: each
                group's first request onboards its whole chain from G2
                (host + peer blocks), no request parks; C's TTFT against
                B's parked TTFT; (c) a fresh prefix, ``kvbm.peer_pull``
                armed as a delay and A's runtime shut down mid-pull: the
                parked request finishes by recompute within
                kvbm_peer_timeout_s + G4_SLACK_S under a watchdog,
                degraded +1, fallbacks >= 1, stream gates; tcp and
                native — the prefill engine in a worker process
                (``dynamo_tpu_torch.examples.prefill_worker``), each
                transport pinned; int8 — an int8-KV pair over tcp
                (packed rows, scales included, by their byte count).
                Gates on every leg: 4 remote, 4 local; the pinned
                transport's receiver carried every block and no other
                did; no integrity failure and no degraded request; the
                device leg's received blocks equal the sent ones by CRC;
                the ragged wrapper launched num_layers times per unified
                dispatch of this process's engines (the prefill worker's
                report: the same of its own, and nothing captured
                mid-traffic), tile and split paths; the streams through
                phase 8's teacher-forced gates. Reported: TTFT p50 of
                the remote and local requests, kv_transfer span p50/p95
                and GB/s per transport, host→device onboard GB/s, TTFT
                cold against host hit, the gate's probes and skips.
11. planner   — the planner over llama3.2-1b worker processes, after the
                in-process engines are freed. calibration: a runner of
                64 slots and a 2048-token budget, graphs captured, times
                unified decode dispatches at 32 and 64 lanes (160 tokens
                of context each) and the engine's full prefill-only
                dispatches of prompts of 128, 512 and 2048 tokens (15, 4
                and 1 of them; device ms from the profiler), pinned
                host→device copies of 1 and 64 KV
                blocks, then an engine on the same weights serves the
                headline, 64 requests of 128 tokens for 64 greedy tokens
                released at once from its warmup gate (tok/s, TTFT p50
                from the first dispatch's start), and once more under
                the profiler (device ms per dispatch beside the wall);
                the record is printed and written to chip_smoke_out/
                calibration_h100.json, planner/calibration.py's law must
                find every price finite and positive; the drift against
                the committed record and the calibrated simulation of
                the headline are reported. aggregated: a control plane,
                the frontend in this process, ``python -m
                dynamo_tpu_torch planner --min-workers 1 --max-workers
                2`` (0.25 s ticks, 2 s adjustments, a state file, a
                decision log) spawning ``run --in dyn://...`` workers
                (the serve's settings, each output in a file); 24
                closed-loop clients (prompts of 64–512 tokens, 64 greedy
                tokens): the decision log must show the scale up, the
                second worker's lease appear and it serve requests (a
                worker the law retires under load, its queue run dry
                while a new worker starts, is counted and the next one
                the planner adds is followed),
                then with the load stopped a scale down within 5
                adjustments, the drained worker printing its report,
                "drain complete" and exiting 0 (the planner logs its
                code), its ragged launches 16 × its dispatches; SIGTERM
                stops the planner (exit 0) and leaves the survivor
                running and in the state file; every stream full length
                and through phase 8's teacher-forced gates. two_pool:
                ``planner --two-pool`` with the prefill pool 1..2
                (``examples.prefill_worker`` on llama3.2-1b) and the
                decode pool 1..1 (a ``run --in dyn://pool.decode...``
                worker), a decode engine in this process whose
                DecodeOperator fills the prefill queue over tcp; 8
                closed-loop remote prompts of 1024–1536 tokens: the
                prefill pool must scale up and its second worker take
                work (report: requests ≥ 1, ragged launches 16 × its
                dispatches), then scale down (exit 0) once the load
                stops, while every decode-pool decision holds at 1;
                the decode worker SIGKILLed (shell and child) must be
                logged on the crash path within a tick and its
                replacement's pid reach the state file; no integrity
                failure, no degraded request, the streams through the
                teacher-forced gates. Reported: seconds from the up
                decision to the new lease and to its first token, TTFT
                p50 before and after, the crash gap.

12. families  — the dense model families at full width (budget: 120 s of
                wall time and 40 GB of peak device memory, both printed
                and gated; each model freed before the next; random bf16
                weights from a seed with the QK-norm and sandwich-norm
                gains and the qkv biases moved off identity). Kernel
                cases: the ragged kernel at gemma3-1b's (H, kvH, D) = (4,
                1, 256) with window 512 in a mixed batch and at
                mistral-7b's (32, 8, 128) with window 4096 at contexts
                4200–4700 over 320-column tables, bf16 and int8, against
                the plain version, unowned rows zero; each again with
                every span's table entries behind its window set to the 0
                sentinel and block 0 filled with NaN (int8: scales inf),
                which must leave the output finite and equal; the
                unpoisoned cases timed beside the fair SDPA call.
                gemma3-1b (26 layers, vocab 262144): 8 prompts of
                300–1200 tokens, 32 greedy tokens, bf16 and int8 KV; one
                streaming completion through the OpenAI server built by
                the CLI on ``preset:gemma3-1b``; prefill_batch +
                decode_multi on 4 lanes. mistral-7b (32 layers): 2
                prompts of 4300–4500 tokens for 256 greedy tokens, with
                the rolling buffer's eviction on and off: the streams
                byte-identical, the live blocks of the second half at
                most 2 × (ceil(window/bs) + 1 + pipeline slack + 1) with
                it and at least the context's blocks without it.
                qwen3-0.6b and qwen2.5-0.5b: 8 prompts of 64–512 tokens.
                Every serve: phase 8's teacher-forced gates, every graph
                captured before traffic, the ragged kernel num_layers
                times per dispatch on the tile and split paths; a
                profiled serve of fresh prompts gives device ms per
                dispatch. Reported per model: tok/s, TTFT p50, device ms
                per dispatch, peak bytes, the card.
13. mla       — DeepSeek-V2-Lite (15.7B: MLA, yarn rope, 64 routed experts
                top-6 + 2 shared after one dense layer) at full width
                (budget: 150 s of wall time and 45 GB of peak device
                memory, both printed and gated; each model freed before
                the next; random weights from a seed drawn on the card
                tensor by tensor). Kernel cases: the ragged kernel at
                MLA's (H, kvH, D) = (16, 1, 576), block size 16, bf16,
                int8 and float32 caches, each in a mixed T=256 batch (8
                decode spans at contexts 600–2100, a 3-row verify span,
                prefill spans, an idle row), a tile-only and a split-only
                batch, against the plain version, unowned rows zero; the
                mixed cases timed beside one SDPA call (the backends that
                take D = 576 printed) and the bound. Witnesses at full
                width, drop-free (``moe_dispatch="dense"``), 8 prompts of
                256–1024 tokens, 32 greedy tokens, under phase 8's
                teacher-forced gates: float32 at 2 layers (layer 0 dense,
                layer 1 MoE) and 8 layers, bf16 at 2 layers (the wide
                tile and the bf16 expert products inside a serve). 27
                layers in bf16: drop-free,
                the preset's ``auto`` (capacity at rungs with T·k >= 2E,
                dense below; one recorded capacity-rung dispatch replayed
                through its graph and eagerly must give equal tokens and
                K/V bytes) and ``auto`` with int8 KV, each on the same
                prompts with every graph captured before traffic and the
                ragged kernel 27 times per dispatch on the tile and split
                paths; one streaming completion through the OpenAI server
                the CLI builds on ``preset:deepseek-v2-lite``. These 27-
                layer streams are held to the no-cache reference at
                per-leg limits (``MLA_BF16_LIMITS``: each leg's repeated
                reading less a margin) instead of phase 8's: with random
                weights the top-k router turns bf16 rounding that depends
                on a product's shape into other experts
                (tools/layer_divergence.py measures it). A profiled serve
                of fresh prompts gives device ms per dispatch and the top
                device ops.
14. multimodal — image chat through a vision encode worker and
                /v1/embeddings on llama3.2-1b at full width (budget:
                MM_BUDGET_S of wall time and MM_PEAK_BYTES of peak device
                memory, printed and gated). The encoder: the shared
                VisionConfig at ViT-B/16's widths (224 px, 16 px patches,
                hidden 768, 12 layers and heads, out 2048: 196 patches,
                ~87M weights, random from a seed on the card),
                ``encode_image`` in bf16 against the same weights in
                float32 (each soft-prompt row's relative error within
                MM_ENCODER_TOL), device and eager ms per image. The
                serve: llama3.2-1b bf16 with ``multimodal=True`` (every
                graph, unified_mm greedy and sampled included, captured
                by the warmup), served with the encode worker on an
                in-process runtime plane through
                examples/multimodal.py's ``deploy``; 8 concurrent
                streaming chats of 64–256 text tokens and 1 or 2 .npy
                images each (224 x 224 uint8, one 300 x 200 that the
                worker resizes), 32 greedy tokens: 2 images (392 rows)
                straddle the 256-token dispatches. Gates: every reply 200,
                nothing captured mid-traffic, the ragged kernel 16 times
                per dispatch on the tile and split paths and 16 times per
                mm dispatch, phase 8's teacher-forced gates with the same
                embeddings spliced into ``reference_forward`` (and at
                most 0.5 against the reference without them); then, each
                alone, one image request twice gives byte-identical
                streams, the same text with two other images reuses no
                block, and a text-only request equals the stream of an
                engine without ``multimodal``. The raw entry point: one
                ``runner.prefill(mm_embeds=)``, the paged prefill kernel
                once per layer, its first token the reference's argmax.
                Embeddings: ``run --in http --out torch --model-type
                embeddings --model-path preset:llama3.2-1b`` as a
                process of its own (started with the phase), 8 inputs of
                16–2048 tokens (text and token ids): unit norms within
                1e-3, cosine >= 0.995 against ``embed_forward`` in float32
                on the same seeded weights, ms per request and tok/s.
                Reported: tok/s, TTFT p50 of the image chats and the
                text-only one, device ms per mm dispatch.

Each path's launch counts are set to 0 just before it and read just
after. Then the card's name and power limit, the kernels line, and the
last line ``{"ok": true, "device": {...}}``. When any gate of any phase
fails (or anything raises), the script prints one line ``{"failed":
{"phase", "gate", "value", "limit"}}`` and exits non-zero. Imports
nothing of JAX or of the JAX package. Needs one CUDA device.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import gc
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FLOPS = {                # H100 SXM dense peaks
    torch.bfloat16: 989e12,   # tensor cores
    torch.float32: 67e12,     # outside the tensor cores
}
KERNEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DEVICE = "cuda"
H, KVH, D, BS = 32, 8, 64, 16        # llama3.2-1b attention shapes
G = H // KVH
SP = 4                               # kv_sp shards emulated on one card
PHASE_LANES = 4                      # lanes of the full-width phase-split run
# The full-width phase-split run against the no-cache reference, fed the
# run's own tokens: argmax agreement; where the argmax differs, the run's
# token must be a near tie in the reference's log-probabilities; and the
# first token's log-probability from prefill_batch against the reference.
# Random bf16 weights give near-flat logits: the reference's top two
# tokens lie a median ~0.025 nats apart, and bf16 rounding moves a
# log-probability by a few thousandths, so a flipped argmax within 0.02
# nats is a tie and a wrong token is not.
PHASES_AGREEMENT = 0.9
NEAR_TIE_NATS = 0.02
FIRST_LOGPROB_TOL = 0.02


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# The phase running now: a failed gate names it in the failure line.
CURRENT = {"phase": "start"}


class GateFailed(SystemExit):
    """A gate that did not hold: the phase, the gate, its value and its
    limit, printed by ``main`` as one JSON line before the exit."""

    def __init__(self, gate: str, value=None, limit=None, phase: str | None = None):
        super().__init__(gate)
        self.record = {"phase": phase or CURRENT["phase"], "gate": gate,
                       "value": value, "limit": limit}


def fail(gate: str, value=None, limit=None, phase: str | None = None):
    raise GateFailed(gate, value, limit, phase)


def run_phase(name: str, fn, *args):
    """Run one phase (a coroutine function runs in its own event loop),
    named in the failure line if a gate of it fails."""
    CURRENT["phase"] = name
    t0 = time.monotonic()
    out = fn(*args)
    out = asyncio.run(out) if asyncio.iscoroutine(out) else out
    emit({"phase_wall_s": {name: round(time.monotonic() - t0, 1)}})
    return out


def failure_record(exc: BaseException) -> dict:
    """The failure line's content for whatever ended the run."""
    if isinstance(exc, GateFailed):
        return exc.record
    gate = str(exc) if isinstance(exc, SystemExit) else f"{type(exc).__name__}: {exc}"
    return {"phase": CURRENT["phase"], "gate": gate[-4000:], "value": None, "limit": None}


def device_ms(fn, iters: int) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA
    graph and replayed, so the host's launch overhead is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def host_ms(fn, iters: int) -> float:
    """Wall time per back-to-back fn() call as issued from Python: the
    larger of the host's launch cost and the device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check(phase: str, case: str, errs: dict, tol: float, **extra) -> float:
    """Emit one case's errors against its plain version; fail if any is
    over the tolerance or not finite."""
    flag = extra.pop("ok", True)
    worst = max(errs.values())
    ok = bool(np.isfinite(worst)) and worst <= tol and flag
    emit({"phase": phase, "case": case, **errs, "tol": tol, **extra, "ok": ok})
    if not ok:
        fail(f"{phase} case {case} disagrees with the plain version", worst, tol)
    return worst


def t_(a):
    return torch.from_numpy(np.asarray(a)).to(DEVICE)


def timing(case: str, kernel, plain, library, lib_want, nbytes, flops, dtype,
           kernel_iters=20) -> dict:
    """Time a main case: kernel, plain version and library call on the
    same inputs, beside the bound computed from this run's inputs."""
    kernel_ms = device_ms(kernel, iters=kernel_iters)
    plain_ms = device_ms(plain, iters=2)
    lib_got, lib_mask = library()
    lib_err = max_err(lib_got[lib_mask], lib_want[lib_mask])
    library_ms = device_ms(library, iters=5)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    out = {"phase": "kernel_timing", "case": case, "kernel_ms": kernel_ms,
           "kernel_host_ms": host_ms(kernel, iters=50), "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_err": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops, "bound_share": bound_ms / kernel_ms}
    emit(out)
    return out


# -- phase 1 -----------------------------------------------------------------
def phase_build() -> None:
    from dynamo_tpu_torch.ops.kernels import (
        KERNEL_SOURCES,
        _build,
        paged_decode_attention,
        paged_prefill_attention,
        ragged_attention,
        wq_gemm,
    )

    t0 = time.monotonic()
    reports = _build.build_all(KERNEL_SOURCES)
    for module in (ragged_attention, paged_decode_attention, paged_prefill_attention, wq_gemm):
        module.build()
    try:
        # Renders a model file's chat template (phase files); torch
        # depends on it.
        import jinja2

        jinja = jinja2.__version__
    except ImportError:
        jinja = None
    emit({"phase": "build", "kernels": KERNEL_SOURCES, "jinja2": jinja,
          "build_s": round(time.monotonic() - t0, 3),
          "nvcc_s": {name: float(text.rsplit("nvcc seconds:", 1)[1])
                     for name, text in reports.items()},
          "ptxas": ptxas_summary(reports)})


def ptxas_summary(reports: dict) -> dict:
    """{kernel<template args>: [registers, spill store bytes]} from the
    compiler's -Xptxas -v report, the mangled names cut to their core."""
    import re

    out, entry = {}, None
    for text in reports.values():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                m = re.search(r"\d+([a-z_]+_kernel)I(.*?)E+v", name)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else name
                out[entry] = [0, 0]
            elif entry and "spill stores" in line:
                out[entry][1] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif entry and "registers" in line:
                out[entry][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# -- phase 2: shared inputs --------------------------------------------------
def make_cache(rng, num_blocks, dtype, kvh=KVH, d=D, bs=BS):
    """Random paged K/V caches; an int8 cache comes with per-(block, kv
    head) scales."""
    shape = (num_blocks * bs, kvh, d)
    if dtype == torch.int8:
        k, v = (t_(rng.integers(-127, 128, shape).astype(np.int8)) for _ in range(2))
        ks, vs = (t_(rng.uniform(0.002, 0.02, (num_blocks, kvh)).astype(np.float32))
                  for _ in range(2))
        return dict(k=k, v=v, ks=ks, vs=vs)
    return dict(k=t_(rng.standard_normal(shape)).to(dtype),
                v=t_(rng.standard_normal(shape)).to(dtype))


def dense_kv(c):
    """The caches in q's dtype (int8 pages dequantized by their scales),
    for the library yardstick."""
    if "ks" not in c:
        return c["k"], c["v"]
    bs = c["k"].shape[0] // c["ks"].shape[0]
    return tuple(
        (c[n].float() * c[s].repeat_interleave(bs, 0)[:, :, None]).to(c["q"].dtype)
        for n, s in (("k", "ks"), ("v", "vs"))
    )


def disjoint_tables(rng, rows, max_blocks, num_blocks):
    ids = rng.permutation(np.arange(1, num_blocks))[: rows * max_blocks]
    return ids.reshape(rows, max_blocks).astype(np.int32)


def striped_tables(rng, rows, max_blocks, num_blocks, sp=SP):
    """Tables under the striped allocator: logical page i lives on shard
    i % sp, whose blocks are [r*nb/sp, (r+1)*nb/sp)."""
    local = num_blocks // sp
    pools = [list(rng.permutation(np.arange(r * local + 1, (r + 1) * local)))
             for r in range(sp)]
    tables = np.zeros((rows, max_blocks), np.int32)
    for b in range(rows):
        for i in range(max_blocks):
            tables[b, i] = pools[i % sp].pop()
    return tables


def gather_dense(k, v, tables, L, bs=BS, g=G):
    """Each row's first L keys gathered dense, heads repeated for GQA
    (``g`` query heads per kv head): [rows, H, L, D] — the library
    yardstick's input, built once."""
    keys = torch.arange(L, device=DEVICE)
    slots = tables.long()[:, keys // bs] * bs + keys % bs        # [rows, L]
    return tuple(x[slots].permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
                 for x in (k, v))


# -- phase 2a: ragged ----------------------------------------------------------
def make_case(rng, spans, T, dtype, num_blocks=1024, max_blocks=48,
              dims=(H, KVH, D, BS), kv_dtype=None, gap=0):
    """Random paged caches and a flat batch for spans [(q_start, q_len)],
    packed from row 0 with ``gap`` unowned rows before each span; each
    span gets its own disjoint blocks."""
    h, kvh, d, bs = dims
    S = len(spans)
    c = make_cache(rng, num_blocks, kv_dtype or dtype, kvh, d, bs)
    tables = disjoint_tables(rng, S, max_blocks, num_blocks)
    q_start = np.array([a for a, _ in spans], np.int32)
    q_len = np.array([b for _, b in spans], np.int32)
    row_start = np.zeros(S, np.int32)
    token_seq = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    cursor = 0
    for s, (qs, ql) in enumerate(spans):
        cursor += gap
        row_start[s] = cursor
        token_seq[cursor:cursor + ql] = s
        token_pos[cursor:cursor + ql] = np.arange(qs, qs + ql)
        cursor += ql
    assert cursor <= T
    assert max(qs + ql for qs, ql in spans) <= max_blocks * bs
    c.update(
        q=t_(rng.standard_normal((T, h, d))).to(dtype), tables=t_(tables),
        q_start=t_(q_start), q_len=t_(q_len), kv_len=t_(q_start + q_len),
        row_start=t_(row_start), token_seq=t_(token_seq),
        token_pos=t_(token_pos), spans=spans, bs=bs, dims=dims,
    )
    return c


def run_kernel(c, window=0):
    """The wrapper's call; a bf16 call must launch the tensor-core tile and
    the split path, an f32 call the walk and the split path."""
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )

    before = (fn.launches_tc, fn.launches_walk, fn.launches_split)
    out = fn(
        c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["q_len"],
        c["kv_len"], c["row_start"], c["bs"], window=window,
        k_scales=c.get("ks"), v_scales=c.get("vs"),
    )
    bf16 = c["q"].dtype == torch.bfloat16
    moved = tuple(b - a for a, b in zip(before, (fn.launches_tc, fn.launches_walk,
                                                 fn.launches_split)))
    if moved != (int(bf16), int(not bf16), 1):
        fail(f"ragged {c['q'].dtype} call launched the paths {moved}")
    return out


def run_plain(c, window=0):
    from dynamo_tpu_torch.ops.attention import ragged_paged_attention

    return ragged_paged_attention(
        c["q"], c["k"], c["v"], c["tables"], c["token_seq"], c["token_pos"],
        c["bs"], window, k_scales=c.get("ks"), v_scales=c.get("vs"),
    )


def ragged_work(c, window=0):
    """(bytes, flops) the function must move and do on these inputs:
    each span's visible K/V (and, for int8, its pages' scales) read once,
    q read once, out written once."""
    h, kvh, d, bs = c["dims"]
    el_q, el_kv = c["q"].element_size(), c["k"].element_size()
    T = c["q"].shape[0]
    kv_bytes, flops = 0, 0
    for qs, ql in c["spans"]:
        if ql == 0:
            continue
        first = max(0, qs - window + 1) if window else 0
        kv_bytes += (qs + ql - first) * kvh * d * el_kv * 2
        if "ks" in c:
            kv_bytes += (-(-(qs + ql) // bs) - first // bs) * kvh * 4 * 2
        for pos in range(qs, qs + ql):
            lo = max(0, pos - window + 1) if window else 0
            flops += 4 * (pos + 1 - lo) * h * d
    io = 2 * T * h * d * el_q + c["tables"].numel() * 4 + 4 * 4 * len(c["spans"])
    return kv_bytes + io, flops


def ragged_library(c, window=0):
    """One scaled_dot_product_attention call over the spans padded — a
    yardstick only (the port never calls it): q [S, H, Qmax, D]; each
    span's visible keys gathered ONCE, [S, H, Lmax, D], the GQA heads
    repeated outside the timed call; a boolean mask with each row's
    causal, context and window bound (a row that sees nothing sees key 0,
    and is not compared). Returns (the call, giving (out [S, Qmax, H, D],
    owned rows [S, Qmax]), the flat rows [S, Qmax] its rows stand for)."""
    import torch.nn.functional as F

    T = c["q"].shape[0]
    Qmax = max(ql for _, ql in c["spans"])
    L = max(qs + ql for qs, ql in c["spans"])
    i = torch.arange(Qmax, device=DEVICE)
    rows = (c["row_start"].long()[:, None] + i).clamp(max=T - 1)          # [S, Qmax]
    owned = i[None, :] < c["q_len"].long()[:, None]
    qd = c["q"][rows].permute(0, 2, 1, 3).contiguous()                     # [S, H, Qmax, D]
    kd, vd = gather_dense(*dense_kv(c), c["tables"], L, c["bs"],
                          c["q"].shape[1] // c["k"].shape[1])
    keys = torch.arange(L, device=DEVICE)
    pos = c["q_start"].long()[:, None] + i                                  # [S, Qmax]
    mask = (keys <= pos[..., None]) & (keys < c["kv_len"].long()[:, None, None])
    if window:
        mask &= keys > pos[..., None] - window
    mask = (mask | (~mask.any(-1, keepdim=True) & (keys == 0)))[:, None]   # [S, 1, Qmax, L]

    def call():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask).permute(
            0, 2, 1, 3), owned

    call.inputs = (qd, kd, vd, mask)
    return call, rows


def phase_ragged() -> tuple[dict, dict]:
    """Each case against the plain version, unowned rows exactly zero;
    the mixed T=256 batch (the serve's budget: 8 decode spans at contexts
    100–600, prefill spans of 64, 64 and 100 rows, an idle span) timed
    for both legs beside the fair per-span SDPA call. Every bf16 call
    must launch the tile and the split path, every f32 call the walk and
    the split path."""
    rng = np.random.default_rng(0)
    bf16, f32, int8 = torch.bfloat16, torch.float32, torch.int8
    decode = [(c - 1, 1) for c in (64, 130, 257, 300, 411, 512, 600, 1)]
    mixed = [(c - 1, 1) for c in (100, 180, 250, 333, 420, 480, 530, 600)] + [
        (0, 64), (128, 64), (32, 100), (0, 0)
    ]
    spec = [(300, 4), (50, 1), (0, 10), (0, 0)]
    # Spec-verify spans of 2, 4 and 8 rows (8 is past SPLIT_ROWS: the tile).
    spec_rows = [(700, 2), (333, 4), (900, 8), (511, 1), (0, 3), (0, 0)]
    # The longest context a 64-column table holds (many splits).
    long_decode = [(1023, 1), (0, 0), (640, 1)]
    # Spans that end mid-tile right before the next span's rows (37 and 45
    # rows x G = 4: 20 and 52 vectors into their last tile).
    trap = [(5, 37), (40, 3), (0, 45), (77, 1), (200, 130), (11, 5)]
    # With window 100: decode spans whose early splits lie wholly behind
    # it, a prefill span whose first chunks do, spec spans at long context.
    behind = [(1023, 1), (600, 100), (899, 4), (300, 8), (960, 2), (0, 0)]
    main = (H, KVH, D, BS)
    # (name, spans, T, q dtype, window, dims, kv dtype, make_case keywords)
    cases = [
        ("decode_only", decode, 16, bf16, 0, main, None, {}),
        ("prefill_prefix_hit", [(0, 128), (64, 100)], 256, bf16, 0, main, None, {}),
        ("mixed_T256", mixed, 256, bf16, 0, main, None, {}),
        ("spec_verify_4rows", spec, 16, bf16, 0, main, None, {}),
        ("spec_2_4_8rows", spec_rows, 32, bf16, 0, main, None, dict(max_blocks=64)),
        ("decode_ctx1024", long_decode, 8, bf16, 0, main, None, dict(max_blocks=64)),
        ("decode_ctx1024_w100", long_decode, 8, bf16, 100, main, None,
         dict(max_blocks=64)),
        ("trap_mid_tile_gaps", trap, 256, bf16, 0, main, None, dict(gap=3)),
        ("windowed_mixed", mixed, 256, bf16, 128, main, None, {}),
        ("window_behind_w100", behind, 160, bf16, 100, main, None, dict(max_blocks=64)),
        ("mixed_f32", mixed, 256, f32, 0, main, None, {}),
        ("spec_window_f32", behind, 160, f32, 100, main, None, dict(max_blocks=64)),
        ("int8_decode_only", decode, 16, bf16, 0, main, int8, {}),
        ("int8_mixed_T256", mixed, 256, bf16, 0, main, int8, {}),
        ("int8_windowed_mixed", mixed, 256, bf16, 128, main, int8, {}),
        ("int8_spec_verify_4rows", spec, 16, bf16, 0, main, int8, {}),
        ("int8_spec_2_4_8rows_w100", spec_rows, 32, bf16, 100, main, int8,
         dict(max_blocks=64)),
        ("int8_window_behind_w100", behind, 160, bf16, 100, main, int8,
         dict(max_blocks=64)),
        ("int8_trap_mid_tile_gaps", trap, 256, bf16, 0, main, int8, dict(gap=3)),
        ("int8_mixed_f32", mixed, 256, f32, 0, main, int8, {}),
        ("int8_spec_window_f32", behind, 160, f32, 100, main, int8, dict(max_blocks=64)),
    ]
    # Block size 4, and every head-dim template of the tile (16..256, 96 on
    # the 128 template) and of the walk, with G = 1, 2, 3, 4, 8, 16, on a
    # shorter mixed batch with a spec span.
    short = [(99, 1), (179, 1), (0, 64), (32, 100), (60, 3), (0, 0)]
    cases += [("bs4" + kv, [(150, 1), (0, 40), (60, 3), (100, 70), (0, 0)], 128, dt, w,
               (H, KVH, D, 4), kvd, dict(max_blocks=64))
              for dt in (bf16, f32) for kvd, kv in ((None, ""), (int8, "_int8"))
              for w in (0, 30)]
    for dims in [(4, 2, 16, 4), (8, 4, 32, 16), (8, 8, 96, 16), (24, 8, 96, 16),
                 (32, 2, 96, 16), (32, 8, 128, 16), (16, 2, 256, 16)]:
        for dt in (bf16, f32):
            for kv in (None, int8):
                name = "shape_H%d_kvH%d_D%d_bs%d" % dims + ("_int8" if kv else "")
                mb = 64 if dims[3] == 4 else 48
                cases.append((name, short, 256, dt, 0, dims, kv, dict(max_blocks=mb)))
    worst = {"plain": 0.0, "int8": 0.0}
    kept = {}
    for name, spans, T, dtype, window, dims, kv, kw in cases:
        c = make_case(rng, spans, T, dtype, dims=dims, kv_dtype=kv, **kw)
        got = run_kernel(c, window)
        want = run_plain(c, window)
        torch.cuda.synchronize()
        unowned = c["token_pos"] < 0
        pad_zero = bool((got[unowned] == 0).all().item())
        err = check("kernel", "ragged_" + name, {"max_abs_err": max_err(got, want)},
                    KERNEL_TOL[dtype], ok=pad_zero, dtype=str(dtype).split(".")[-1],
                    kv_dtype=str(kv or dtype).split(".")[-1], T=T,
                    spans=len(spans), window=window, H_kvH_D_bs=list(dims),
                    splits_pages=ragged_plan(c, window),
                    unowned_rows_zero=pad_zero)
        if dtype == bf16:
            leg = "int8" if kv else "plain"
            worst[leg] = max(worst[leg], err)
        if name in ("mixed_T256", "int8_mixed_T256"):
            kept[name] = c
    out = []
    for name in ("mixed_T256", "int8_mixed_T256"):
        c = kept[name]
        nbytes, flops = ragged_work(c)
        library, rows = ragged_library(c)
        out.append(timing(
            "ragged_" + name, lambda c=c: run_kernel(c), lambda c=c: run_plain(c),
            library, run_plain(c)[rows], nbytes, flops, torch.bfloat16,
        ))
    out[0]["max_abs_err"], out[1]["max_abs_err"] = worst["plain"], worst["int8"]
    return out[0], out[1]


def ragged_plan(c, window=0) -> list:
    """The split path's (splits, pages per split) for this case, as its
    wrapper computes it."""
    from dynamo_tpu_torch.ops.kernels.ragged_attention import call_split_plan

    return list(call_split_plan(c["q"], c["k"], c["tables"], c["bs"], window))


def contiguous_tables(lens, steps, max_blocks, bs=BS):
    """Each lane's blocks laid end to end from block 1, covering its
    prompt and `steps` more tokens: the phase-split run's block tables.
    Returns (per-lane block lists, [lanes, max_blocks] int32 table)."""
    blocks, nxt = [], 1
    for n in lens:
        need = -(-(n + steps + 1) // bs)
        blocks.append(list(range(nxt, nxt + need)))
        nxt += need
    table = np.zeros((len(lens), max_blocks), np.int32)
    for i, b in enumerate(blocks):
        table[i, :len(b)] = b
    return blocks, table


# -- phase 2b: decode ----------------------------------------------------------
def decode_case(rng, ctxs, dtype, striped=False, num_blocks=1024, max_blocks=48,
                tables=None, dims=(H, KVH, D, BS)):
    h, kvh, d, bs = dims
    c = make_cache(rng, num_blocks, dtype, kvh, d, bs)
    rows = len(ctxs)
    if tables is None:
        tables = (striped_tables if striped else disjoint_tables)(
            rng, rows, max_blocks, num_blocks)
    c.update(q=t_(rng.standard_normal((rows, h, d))).to(dtype), tables=t_(tables),
             ctx=t_(np.asarray(ctxs, np.int32)), ctxs=list(ctxs),
             local=num_blocks // SP, bs=bs)
    return c


def decode_kernel(c, window=0, **kw):
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
        paged_decode_attention_cuda,
    )

    return paged_decode_attention_cuda(
        c["q"], c["k"], c["v"], c["tables"], c["ctx"], c["bs"], window=window, **kw)


def decode_plain(c, window=0, **kw):
    from dynamo_tpu_torch.ops.attention import paged_decode_attention

    return paged_decode_attention(
        c["q"], c["k"], c["v"], c["tables"], c["ctx"], c["bs"], window, **kw)


def decode_plan(c, window=0, page_stride=1) -> list:
    """The kernel's (splits, pages per split) for this case, as its
    wrapper computes it."""
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import call_split_plan

    return list(call_split_plan(c["q"], c["k"], c["tables"], c["bs"], window, page_stride))


def shard_of(c, r):
    """Shard r's view of a striped case: its LOCAL cache slice and
    compacted stripe, and its page offset as a [1] int32 on the card."""
    from dynamo_tpu_torch.ops.attention import stripe_tables

    local = c["local"]
    sl = slice(r * local * BS, (r + 1) * local * BS)
    return dict(c, k=c["k"][sl], v=c["v"][sl],
                tables=stripe_tables(c["tables"], r, SP, local)), dict(
        page_offset=torch.tensor([r], dtype=torch.int32, device=DEVICE),
        page_stride=SP, with_stats=True)


def check_striped(phase, case, c, kernel, plain, window, tol, **extra):
    """Each shard's kernel call (out, m, l) against its plain version
    (l relative to max(l, 1): it sums up to hundreds of terms), and the
    merged shards against the unstriped kernel call and the unstriped
    plain version."""
    from dynamo_tpu_torch.ops.attention import merge_stats

    parts, errs = [], {"out": 0.0, "m": 0.0, "l_rel": 0.0}
    for r in range(SP):
        sc, kw = shard_of(c, r)
        got, want = kernel(sc, window, **kw), plain(sc, window, **kw)
        parts.append(got)
        errs["out"] = max(errs["out"], max_err(got[0], want[0]))
        errs["m"] = max(errs["m"], max_err(got[1], want[1]))
        rel = ((got[2] - want[2]).abs() / want[2].clamp(min=1.0)).max().item()
        errs["l_rel"] = max(errs["l_rel"], rel)
    # The unstriped calls with stats too: float32 out, as the merge's.
    merged = merge_stats(parts)
    whole = kernel(c, window, with_stats=True)[0]
    errs["merged_vs_unstriped_kernel"] = max_err(merged, whole)
    errs["merged_vs_unstriped_plain"] = max_err(
        merged, plain(c, window, with_stats=True)[0])
    return check(phase, case, errs, tol, shards=SP, window=window, **extra)


def decode_work(c):
    el = c["q"].element_size()
    keys = sum(c["ctxs"])
    nbytes = keys * KVH * D * el * 2 + 2 * c["q"].numel() * el + c["tables"].numel() * 4
    return nbytes, 4 * keys * H * D


def decode_library(c):
    import torch.nn.functional as F

    L = max(c["ctxs"])
    kd, vd = gather_dense(c["k"], c["v"], c["tables"], L)
    keys = torch.arange(L, device=DEVICE)
    mask = keys[None, :] < c["ctx"][:, None]
    mask = (mask | (c["ctx"][:, None] == 0) & (keys == 0)[None, :])[:, None, None, :]
    qd = c["q"][:, :, None, :]
    owned = c["ctx"] > 0
    return lambda: (F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)[:, :, 0, :],
                    owned)


def phase_decode(lens, steps) -> dict:
    """The main case is the phase-split run's own: its lanes (prompts of
    `lens` tokens, contiguous tables of the full-width config's width),
    checked at its first, middle and last decode step and timed at the
    middle one. Then 8 lanes of contexts 1–600 with an idle lane (bf16
    and f32, windowed) and a striped sp=4 scan as further checks."""
    rng = np.random.default_rng(1)
    bf16, tol = torch.bfloat16, KERNEL_TOL
    ecfg = full_width_config()
    _, table = contiguous_tables(lens, steps, ecfg.max_blocks_per_seq)
    worst, main = 0.0, None
    for step in (0, steps // 2, steps - 1):
        c = decode_case(rng, [n + 1 + step for n in lens], bf16,
                        num_blocks=ecfg.num_blocks, tables=table)
        worst = max(worst, check(
            "kernel", f"decode_phases_step{step}",
            {"max_abs_err": max_err(decode_kernel(c), decode_plain(c))}, tol[bf16],
            lanes=len(lens), contexts=c["ctxs"], max_blocks=table.shape[1]))
        if step == steps // 2:
            main = c
    ctxs = [1, 64, 130, 257, 300, 411, 512, 600, 0]     # 8 lanes + an idle lane
    lanes32 = [int(x) for x in rng.integers(1, 385, 32)]
    lanes32[5] = lanes32[17] = 0                         # idle lanes
    # (name, contexts, dtypes, windows, make_cache/tables keywords): the
    # split kernel at one split (40 lanes fill the card), two (32 lanes),
    # many (1 lane at the longest context a 64-column table holds, with a
    # window that leaves whole splits behind), and the other head shapes
    # (head dims 16..256, G = 3 and G = 16, block size 4).
    cases = [
        ("", ctxs, (bf16, torch.float32), (0, 128), {}),
        ("_b1_ctx1024", [1024], (bf16,), (0, 128, 100), dict(max_blocks=64)),
        ("_b32", lanes32, (bf16, torch.float32), (0, 128), dict(max_blocks=24)),
        ("_b40", [int(x) for x in rng.integers(0, 385, 40)], (bf16,), (0,),
         dict(max_blocks=24)),
    ]
    short = [1, 77, 130, 300, 0]
    for dims in [(4, 2, 16, 4), (24, 8, 96, 16), (32, 8, 128, 16), (16, 2, 256, 16),
                 (32, 2, 64, 16)]:
        mb = 96 if dims[3] == 4 else 24
        cases.append(("_H%d_kvH%d_D%d_bs%d" % dims, short, (bf16, torch.float32), (0, 40),
                      dict(dims=dims, max_blocks=mb)))
    for name, cx, dtypes, windows, kw in cases:
        for dtype in dtypes:
            c = decode_case(rng, cx, dtype, **kw)
            for window in windows:
                got, want = decode_kernel(c, window), decode_plain(c, window)
                idle = [i for i, n in enumerate(cx) if n == 0]
                idle_zero = bool((got[idle] == 0).all().item()) if idle else True
                err = check("kernel", f"decode{name}_{str(dtype)[6:]}_w{window}",
                            {"max_abs_err": max_err(got, want)}, tol[dtype],
                            ok=idle_zero, lanes=len(cx), max_context=max(cx),
                            window=window, splits_pages=decode_plan(c, window),
                            H_kvH_D_bs=list(kw.get("dims", (H, KVH, D, BS))),
                            idle_lanes_zero=idle_zero)
                if dtype == bf16:
                    worst = max(worst, err)
    c = decode_case(rng, ctxs, bf16, striped=True)
    for window in (0, 128):
        check_striped("kernel", f"decode_striped_sp{SP}", c, decode_kernel,
                      decode_plain, window, tol[bf16],
                      splits_pages=decode_plan(shard_of(c, 0)[0], window, SP))
    nbytes, flops = decode_work(main)
    out = timing(f"decode_phases_{len(lens)}lanes_step{steps // 2}_bf16",
                 lambda: decode_kernel(main), lambda: decode_plain(main),
                 decode_library(main), decode_plain(main), nbytes, flops, bf16)
    out["max_abs_err"] = worst
    return out


# -- phase 2c: prefill -------------------------------------------------------
def prefill_case(rng, lanes, T, dtype, striped=False, num_blocks=1024, max_blocks=48,
                 tables=None, dims=(H, KVH, D, BS)):
    h, kvh, d, bs = dims
    c = make_cache(rng, num_blocks, dtype, kvh, d, bs)
    N = len(lanes)
    if tables is None:
        tables = (striped_tables if striped else disjoint_tables)(
            rng, N, max_blocks, num_blocks)
    c.update(q=t_(rng.standard_normal((N, T, h, d))).to(dtype), tables=t_(tables),
             q_start=t_(np.asarray([a for a, _ in lanes], np.int32)),
             total=t_(np.asarray([b for _, b in lanes], np.int32)),
             lanes=lanes, local=num_blocks // SP, bs=bs)
    return c


def prefill_kernel(c, window=0, **kw):
    """The wrapper's call; a bf16 call must go through the tensor-core
    entry and an f32 call through the walk."""
    from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
        paged_prefill_attention_cuda as fn,
    )

    tc0 = fn.launches_tc
    out = fn(c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["total"], c["bs"],
             window=window, **kw)
    want_tc = 1 if c["q"].dtype == torch.bfloat16 else 0
    if fn.launches_tc - tc0 != want_tc:
        fail(f"prefill {c['q'].dtype} call took the wrong entry point")
    return out


def prefill_plain(c, window=0, **kw):
    from dynamo_tpu_torch.ops.attention import paged_prefill_attention

    return paged_prefill_attention(
        c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["total"], c["bs"],
        window=window, **kw)


def prefill_work(c):
    el = c["q"].element_size()
    T = c["q"].shape[1]
    keys, flops = 0, 0
    for qs, total in c["lanes"]:
        if total == 0:
            continue
        keys += total
        flops += sum(4 * min(qs + t + 1, total) * H * D for t in range(T))
    nbytes = keys * KVH * D * el * 2 + 2 * c["q"].numel() * el + c["tables"].numel() * 4
    return nbytes, flops


def prefill_library(c):
    import torch.nn.functional as F

    T = c["q"].shape[1]
    L = max(total for _, total in c["lanes"])
    kd, vd = gather_dense(c["k"], c["v"], c["tables"], L)
    keys = torch.arange(L, device=DEVICE)
    qpos = c["q_start"][:, None] + torch.arange(T, device=DEVICE)   # [N, T]
    mask = (keys[None, None, :] <= qpos[:, :, None]) & (
        keys[None, None, :] < c["total"][:, None, None])
    mask = mask | (~mask.any(-1, keepdim=True) & (keys == 0))
    qd = c["q"].permute(0, 2, 1, 3)                                  # [N, H, T, D]
    owned = (c["total"] > 0)[:, None].expand(-1, T)
    return lambda: (F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None]).permute(0, 2, 1, 3), owned)


def phase_prefill(lens, steps) -> dict:
    """The main case is the phase-split run's prefill_batch: its lanes
    (whole prompts of `lens` tokens, no prefix), padded as the runner
    pads them (lanes and T to power-of-two buckets), on its contiguous
    tables; checked and timed. Then 4 lanes of T=256 with prefix hits,
    padded rows and an idle lane (bf16 and f32, windowed) and a striped
    sp=4 scan as further checks."""
    from dynamo_tpu_torch.engine.compile_cache import _bucket

    rng = np.random.default_rng(2)
    bf16 = torch.bfloat16
    ecfg = full_width_config()
    N, T = _bucket(len(lens), minimum=2), _bucket(max(lens))
    _, table = contiguous_tables(lens, steps, ecfg.max_blocks_per_seq)
    table = np.concatenate([table, np.zeros((N - len(lens), table.shape[1]), np.int32)])
    main = prefill_case(rng, [(0, n) for n in lens] + [(0, 0)] * (N - len(lens)), T,
                        bf16, num_blocks=ecfg.num_blocks, tables=table)
    worst = check("kernel", f"prefill_phases_{N}lanes_T{T}",
                  {"max_abs_err": max_err(prefill_kernel(main), prefill_plain(main))},
                  KERNEL_TOL[bf16], lanes=len(lens), T=T, prompt_lens=list(lens),
                  max_blocks=table.shape[1])
    # A whole prompt, a prefix hit, a prefix hit with padded rows, idle.
    lanes = [(0, 256), (128, 384), (64, 264), (0, 0)]
    # (name, lanes, T, dtypes, windows, keywords): the tile's causal and
    # window edges inside 64-key chunks (T=512 behind prefixes that are
    # no multiple of 64, windows of 100), block size 4, and every head
    # dim template (16..256, 96 on the 128 template) with G = 1, 3, 4,
    # 8, 16.
    cases = [
        ("", lanes, 256, (bf16, torch.float32), (0, 128), {}),
        ("_T512_prefix", [(37, 549), (200, 700), (5, 300), (0, 0)], 512, (bf16,),
         (0, 100), {}),
        ("_bs4", lanes, 256, (bf16, torch.float32), (0, 100),
         dict(dims=(H, KVH, D, 4), max_blocks=96)),
    ]
    for dims in [(4, 2, 16, 16), (8, 8, 64, 16), (24, 8, 96, 16), (32, 8, 128, 16),
                 (16, 2, 256, 16), (32, 2, 64, 16)]:
        cases.append(("_H%d_kvH%d_D%d_bs%d" % dims, lanes, 256, (bf16,), (0, 100),
                      dict(dims=dims)))
    for name, ln, rows, dtypes, windows, kw in cases:
        for dtype in dtypes:
            c = prefill_case(rng, ln, rows, dtype, **kw)
            for window in windows:
                got, want = prefill_kernel(c, window), prefill_plain(c, window)
                idle_zero = bool((got[-1] == 0).all().item())
                err = check("kernel", f"prefill{name}_{str(dtype)[6:]}_w{window}",
                            {"max_abs_err": max_err(got, want)}, KERNEL_TOL[dtype],
                            ok=idle_zero, lanes=len(ln), T=rows, window=window,
                            H_kvH_D_bs=list(kw.get("dims", (H, KVH, D, BS))),
                            idle_lane_zero=idle_zero)
                if dtype == bf16:
                    worst = max(worst, err)
    c = prefill_case(rng, lanes, 256, bf16, striped=True)
    for window in (0, 128):
        check_striped("kernel", f"prefill_striped_sp{SP}", c, prefill_kernel,
                      prefill_plain, window, KERNEL_TOL[bf16])
    nbytes, flops = prefill_work(main)
    out = timing(f"prefill_phases_{N}lanes_T{T}_bf16", lambda: prefill_kernel(main),
                 lambda: prefill_plain(main), prefill_library(main),
                 prefill_plain(main), nbytes, flops, bf16)
    out["max_abs_err"] = worst
    return out


# -- phases 3 to 7 -----------------------------------------------------------
async def serve(engine, prompts, max_tokens):
    """Submit every prompt at once through generate(); returns
    (streams, finish reasons, ttft seconds, wall seconds)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        EngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    t0 = time.monotonic()

    async def one(p):
        pre = PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        )
        toks, finish, first = [], None, None
        async for raw in engine.generate(Context(pre.to_wire())):
            out = EngineOutput.from_wire(raw)
            if out.token_ids and first is None:
                first = time.monotonic() - t0
            toks.extend(out.token_ids)
            finish = out.finish_reason or finish
        return toks, finish, first

    results = await asyncio.gather(*[one(p) for p in prompts])
    wall = time.monotonic() - t0
    return (
        [r[0] for r in results], [r[1] for r in results],
        [r[2] for r in results], wall,
    )


async def serve_once(ecfg, params, prompts, max_tokens):
    from dynamo_tpu_torch.engine.engine import TorchEngine

    engine = TorchEngine(ecfg, params=params, device=DEVICE)
    await engine.start()
    try:
        streams, *_ = await serve(engine, prompts, max_tokens)
    finally:
        await engine.stop()
    return streams


def greedy_reference(cfg, params, prompt, n):
    from dynamo_tpu_torch.models import llama

    toks = list(prompt)
    out = []
    for _ in range(n):
        logits = llama.reference_forward(
            cfg, params, torch.tensor(toks, device=DEVICE)
        )
        nxt = int(torch.argmax(logits[-1]).item())
        toks.append(nxt)
        out.append(nxt)
    return out


def teacher_forced(cfg, params, prompts, streams, mm=None) -> dict:
    """The no-cache reference (reference_forward) over each prompt and
    its stream, fed the stream's own tokens: finite logits of shape
    [T, V]; how often its argmax is the stream's next token; where it is
    not, how far the stream's token lies below the reference's top in
    log-probability (a near tie shows rounding, a wide gap a fault);
    the median gap between the reference's top two tokens, for scale;
    and the reference's log-probability of each stream's first token.
    ``mm``, where given, holds each prompt's soft-prompt segments
    ((offset, [n, D] rows)), spliced into the reference at the same rows."""
    from dynamo_tpu_torch.models import llama

    hits, n, gaps, top2, first_lp = 0, 0, [], [], []
    finite = shape_ok = True
    for i, (p, s) in enumerate(zip(prompts, streams)):
        seq = torch.tensor(p + s, device=DEVICE)
        embeds, mask = mm_rows(len(seq), mm[i] if mm else None)
        logits = llama.reference_forward(cfg, params, seq, embeds, mask)
        finite &= bool(torch.isfinite(logits).all().item())
        shape_ok &= tuple(logits.shape) == (len(seq), cfg.vocab_size)
        lp = torch.log_softmax(logits[len(p) - 1:-1].float(), dim=-1)
        want = seq[len(p):].long()
        chosen = lp[torch.arange(len(s), device=DEVICE), want]
        best, arg = lp.max(dim=-1)
        hit = arg == want
        hits += int(hit.sum().item())
        n += len(s)
        gaps += (best - chosen)[~hit].tolist()
        two = lp.topk(2, dim=-1).values
        top2 += (two[:, 0] - two[:, 1]).tolist()
        first_lp.append(chosen[0].item())
    return {
        "logits_finite": finite, "logits_shape_ok": shape_ok,
        "greedy_agreement_vs_no_cache_reference": hits / max(n, 1),
        "disagreements": len(gaps),
        "max_logprob_gap_at_disagreement": max(gaps, default=0.0),
        "median_top2_logprob_gap": float(np.median(top2)),
        "first_token_ref_logprob": first_lp,
    }


def match_rate(a_streams, b_streams) -> float:
    pairs = [(x, y) for a, b in zip(a_streams, b_streams) for x, y in zip(a, b)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_split(runner, prompts, steps):
    """prefill_batch of the prompts, then decode_multi of ``steps`` steps
    on contiguous blocks; returns (per-prompt streams of steps + 1
    tokens, timings)."""
    B = len(prompts)
    blocks, table = contiguous_tables(
        [len(p) for p in prompts], steps, runner.cfg.max_blocks_per_seq,
        runner.cfg.block_size)
    lanes = [(p, b, 0, (0.0, 0, 1.0)) for p, b in zip(prompts, blocks)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = runner.prefill_batch(lanes)
    t1 = time.perf_counter()
    lens = np.asarray([len(p) for p in prompts], np.int32)
    zeros = np.zeros(B, np.float32)
    multi = runner.decode_multi(
        np.asarray(first, np.int32), lens, table, lens + 1, zeros,
        np.zeros(B, np.int32), zeros + 1.0, num_steps=steps,
    )
    t2 = time.perf_counter()
    streams = [[first[i]] + [int(row[i]) for row in multi] for i in range(B)]
    return streams, {"prefill_batch_ms": (t1 - t0) * 1e3,
                     "decode_multi_ms": (t2 - t1) * 1e3,
                     "decode_ms_per_step": (t2 - t1) * 1e3 / steps}


async def phase_tiny() -> None:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.tiny_test()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    params = llama.init_params(cfg, g, dtype=torch.float32, device=DEVICE)
    ecfg = EngineConfig(
        model=cfg, dtype="float32", block_size=4, num_blocks=64,
        max_num_seqs=4, max_model_len=128, unified_token_budget=64,
        unified_prefill_quantum=16,
    )
    engine = TorchEngine(ecfg, params=params, device=DEVICE)
    await engine.start()
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8], list(range(1, 41))]
    n = 8
    try:
        streams, finishes, _, _ = await serve(engine, prompts, n)
    finally:
        await engine.stop()
    want = [greedy_reference(cfg, params, p, n) for p in prompts]
    ok = streams == want
    emit({"phase": "tiny", "model": cfg.name, "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts],
          "quantum": ecfg.unified_prefill_quantum, "streams_equal_reference": ok,
          "dispatches": engine.unified_dispatches})
    if not ok:
        fail(f"tiny engine streams {streams} != reference {want}")

    int8 = await serve_once(dataclasses.replace(ecfg, kv_quant="int8"), params,
                            prompts, n)
    rate = match_rate(int8, want)
    emit({"phase": "tiny_int8", "model": cfg.name, "kv_quant": "int8",
          "greedy_match_rate_vs_unquantized": rate, "gate": 0.7, "ok": rate >= 0.7})
    if rate < 0.7:
        fail(f"tiny int8 serve matched {rate:.2f} < 0.7")

    runner = ModelRunner(ecfg, params=params, device=DEVICE)
    split, _ = phase_split(runner, prompts, n - 1)
    ok = split == want
    emit({"phase": "tiny_phases", "model": cfg.name, "dtype": "float32",
          "prefill_batch_decode_multi_equal_reference": ok})
    if not ok:
        fail(f"tiny prefill_batch + decode_multi {split} != {want}")


def full_width_config(**kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    return EngineConfig(**{
        "model": ModelConfig.llama32_1b(), "dtype": "bfloat16", "block_size": 16,
        "num_blocks": 1024, "max_num_seqs": 8, "max_model_len": 1024,
        "prefill_batch": 4, "unified_token_budget": 256,
        "unified_prefill_quantum": 64, "seed": 0, **kw,
    })


async def serve_full(ecfg, prompts, max_tokens, phase, profile_prompts=None):
    """Serve at full width with the ragged kernel's launches counted over
    exactly this serve; returns (result line, engine, streams)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    cfg = ecfg.model
    # Random weights from torch.Generator(seed=ecfg.seed) on the card.
    engine = TorchEngine(ecfg, device=DEVICE)
    await engine.start()
    profile = None
    try:
        capture = await warm_up(engine)
        recorded = record_dispatches(engine.runner)
        reset_counts()
        reset_wq()
        streams, finishes, ttft, wall = await serve(engine, prompts, max_tokens)
        recorded.stop()
        capture["mid_traffic_compiles_total"] = mid_traffic(engine)
        wq = wq_counts()
        launches = fn.launches
        paths = {"tc": fn.launches_tc, "split": fn.launches_split, "walk": fn.launches_walk}
        dispatches = engine.unified_dispatches
        prefill_tokens = engine.unified_prefill_tokens
        decode_tokens = engine.unified_decode_tokens
        if profile_prompts is not None:
            profile = await profile_serve(engine, profile_prompts, max_tokens)
            profile["of"] = phase
    finally:
        await engine.stop()
    full = all(len(s) == max_tokens for s in streams) and all(
        f is FinishReason.LENGTH for f in finishes
    )
    in_vocab = all(0 <= t < cfg.vocab_size for s in streams for t in s)
    # The served model's logits on every request, recomputed without the
    # cache and fed the streams' own tokens.
    ref = teacher_forced(cfg, engine.runner.params, prompts, streams)
    ref.pop("first_token_ref_logprob")
    total = sum(len(s) for s in streams)
    result = {
        "phase": phase, "model": cfg.name, "dtype": ecfg.dtype,
        "kv_quant": ecfg.kv_quant, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts],
        "max_tokens": max_tokens, "generated_tokens": total,
        "wall_s": wall, "tokens_per_s": total / wall,
        "ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "ttft_max_ms": max(ttft) * 1e3,
        "unified_dispatches": dispatches,
        "prefill_tokens": prefill_tokens, "decode_tokens": decode_tokens,
        "kernel_launches": launches, "kernel_launches_by_path": paths,
        "wq_gemm": wq, "num_layers": cfg.num_layers, "capture": capture,
        "streams_full_length": full, "tokens_in_vocab": in_vocab, **ref,
    }
    emit(result)
    if profile is not None:
        emit(profile)
    check_capture(phase, capture)
    if launches != cfg.num_layers * dispatches or dispatches == 0:
        fail(f"{phase}: ragged launches for {dispatches} dispatches x "
             f"{cfg.num_layers} layers", launches, cfg.num_layers * dispatches)
    # bf16 q: every call runs the multi-row spans on the tensor-core tile
    # and the one-row spans on the split path; the f32 walk never runs.
    if paths != {"tc": launches, "split": launches, "walk": 0}:
        fail(f"{phase}: ragged paths launched", paths,
             {"tc": launches, "split": launches, "walk": 0})
    if not (full and in_vocab and ref["logits_finite"] and ref["logits_shape_ok"]):
        fail(f"{phase}: served streams failed their checks",
             {"full_length": full, "in_vocab": in_vocab,
              "finite": ref["logits_finite"], "shape": ref["logits_shape_ok"]}, True)
    result["recorded"] = recorded.calls
    return result, engine, streams


async def warm_up(engine) -> dict:
    """``engine.warmup()`` (one CUDA graph per program of the plan) and
    what it made: graphs, the seconds of their warm passes and captures,
    the pool's bytes."""
    t0 = time.monotonic()
    programs = await engine.warmup()
    wall = time.monotonic() - t0
    return {"warmup_programs": programs, "warmup_wall_s": wall,
            **engine.runner.compile_stats.capture_snapshot()}


def mid_traffic(engine) -> int:
    return engine.runner.compile_stats.snapshot()["mid_traffic_compiles_total"]


def check_capture(phase: str, capture: dict) -> None:
    """After a full warmup every dispatch replays a graph captured ahead
    of traffic: none is captured mid-traffic."""
    if capture["graphs_captured"] != capture["warmup_programs"] or not capture[
            "graphs_captured"]:
        fail(f"{phase}: graphs captured against warmup programs",
             capture["graphs_captured"], capture["warmup_programs"])
    if capture["mid_traffic_compiles_total"]:
        fail(f"{phase}: mid-traffic captures after warmup "
             f"{capture['mid_traffic_keys']}", capture["mid_traffic_compiles_total"], 0)


class record_dispatches:
    """Records every ``unified_step`` call of a runner (copies of its
    lanes, feed rows, drafts and extras) until ``stop()``; the ``graphs``
    and ``spec`` phases replay and inspect them."""

    def __init__(self, runner) -> None:
        self.runner, self.calls = runner, []
        step = runner.unified_step

        def recording(lanes, feed=None, draft_lens=None, extras=None, mm=None):
            fed = None if feed is None else (
                feed[0] is not None, np.array(feed[1]), np.array(feed[2]))
            self.calls.append((
                [(list(t), list(b), p, tuple(smp)) for t, b, p, smp in lanes],
                fed, None if draft_lens is None else list(draft_lens),
                None if extras is None else {k: list(v) for k, v in extras.items()},
            ))
            return step(lanes, feed=feed, draft_lens=draft_lens, extras=extras, mm=mm)

        runner.unified_step = recording

    def stop(self) -> None:
        del self.runner.unified_step


async def profile_serve(engine, prompts, max_tokens) -> dict:
    """Serve `prompts` under torch.profiler; device time by kernel name
    and the busy share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    d0 = engine.unified_dispatches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        *_, wall = await serve(engine, prompts, max_tokens)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for e in prof.events():   # device-side events only: kernels and copies
        if str(e.device_type).endswith("CUDA"):
            name = e.name[:48]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    n = engine.unified_dispatches - d0
    return {
        "phase": "profile", "dispatches": n, "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "device_busy_share": busy / (wall * 1e3),
        "wall_ms_per_dispatch": wall * 1e3 / n,
        "device_ms_per_dispatch": busy / n,
        "top_kernels_ms": [[k, v, v / busy] for k, v in top],
    }


def cache_difference(a, b, bs: int) -> str | None:
    """Where two runners' KV caches (bytes) or int8 scales differ outside
    trash block 0, or None."""
    for li, ((ka, va), (kb, vb)) in enumerate(zip(a.kv_caches, b.kv_caches)):
        for name, x, y in (("k", ka, kb), ("v", va, vb)):
            if x.dtype != torch.int8:
                x, y = x.view(torch.int16), y.view(torch.int16)
            rows = (x[bs:] != y[bs:]).reshape(x.shape[0] - bs, -1).any(dim=1)
            if bool(rows.any()):
                slot = int(rows.nonzero()[0]) + bs
                return f"layer {li} {name} cache, slot {slot} (block {slot // bs})"
    if a.kv_scales is not None:
        ne = a.kv_scales[:, :, 1:] != b.kv_scales[:, :, 1:]
        if bool(ne.any()):
            li, kv, blk, h = (int(x) for x in ne.nonzero()[0])
            return f"scales layer {li} {'kv'[kv]}, block {blk + 1} head {h}"
    return None


def replay_recorded(runner, step, recorded, depth: int = 2):
    """Issue the recorded dispatches through ``step`` pipelined ``depth``
    deep, each fed by the previous one's device tokens; returns (tokens
    per dispatch, wall s, host s spent inside ``step``)."""
    torch.cuda.synchronize()
    prev, inflight, toks, host = None, [], [], 0.0
    t0 = time.perf_counter()
    for lanes, fed, draft_lens, extras in recorded:
        h0 = time.perf_counter()
        feed = None if fed is None else (prev if fed[0] else None, fed[1], fed[2])
        out = step(lanes, feed=feed, draft_lens=draft_lens, extras=extras)
        host += time.perf_counter() - h0
        prev = out.last
        inflight.append(out)
        if len(inflight) >= depth:
            toks.append(inflight.pop(0).tokens().copy())
    while inflight:
        toks.append(inflight.pop(0).tokens().copy())
    return toks, time.perf_counter() - t0, host


def profiled_device_ms(fn) -> float:
    """Sum of the card's kernel and copy times while ``fn`` runs
    (torch.profiler; kernels inside graph replays included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if str(e.device_type).endswith("CUDA"))


def phase_graphs(params, recorded, kv_quant, phase) -> dict:
    """The serve's dispatches through two runners on the serve's weights
    with caches that start equal: one replays its captured graphs, the
    other runs the eager step body. Every dispatch's sampled tokens, and
    in the end the K/V bytes and int8 scales outside trash block 0, must
    be identical; then wall, host and device ms per dispatch of each,
    in turns (graph, eager, eager, graph), and the device's busy share."""
    from dynamo_tpu_torch.engine.runner import ModelRunner

    ecfg = full_width_config(kv_quant=kv_quant)
    graph = ModelRunner(ecfg, params=params, device=DEVICE)
    eager = ModelRunner(ecfg, params=params, device=DEVICE)
    graph.warmup()
    programs = graph.compile_stats.capture_snapshot()["graphs_captured"]
    got = replay_recorded(graph, graph.unified_step, recorded, depth=1)[0]
    want = replay_recorded(eager, eager.unified_step_eager, recorded, depth=1)[0]
    torch.cuda.synchronize()
    token_mismatch = [i for i, (a, b) in enumerate(zip(got, want))
                      if not np.array_equal(a, b)]
    where = cache_difference(graph, eager, ecfg.block_size)
    legs = {"graph": (graph, graph.unified_step), "eager": (eager, eager.unified_step_eager)}
    timed: dict[str, dict[str, list]] = {k: {} for k in legs}
    for name in ("graph", "eager", "eager", "graph"):
        runner, step = legs[name]
        _, wall, host = replay_recorded(runner, step, recorded)
        n = len(recorded)
        timed[name].setdefault("wall_ms_per_dispatch", []).append(wall * 1e3 / n)
        timed[name].setdefault("host_ms_per_dispatch", []).append(host * 1e3 / n)
    for name, (runner, step) in legs.items():
        holder = {}

        def run(runner=runner, step=step):
            holder["wall"] = replay_recorded(runner, step, recorded)[1]

        dev = profiled_device_ms(run)
        n = len(recorded)
        timed[name]["device_ms_per_dispatch"] = dev / n
        timed[name]["profiled_wall_ms_per_dispatch"] = holder["wall"] * 1e3 / n
        timed[name]["device_busy_share"] = dev / (holder["wall"] * 1e3)
    summary = {
        name: {k: (float(np.median(v)) if isinstance(v, list) else v)
               for k, v in t.items()} for name, t in timed.items()}
    result = {
        "phase": phase, "model": ecfg.model.name, "dtype": ecfg.dtype,
        "kv_quant": kv_quant, "dispatches": len(recorded),
        "graphs_captured": programs,
        "tokens_identical": not token_mismatch,
        "dispatches_with_token_mismatch": token_mismatch[:8],
        "kv_bytes_and_scales_identical_outside_trash_block": where is None,
        "first_difference": where, **summary,
        "runs": timed,
    }
    emit(result)
    if token_mismatch or where is not None:
        fail(f"{phase}: replays differ from the eager body "
                         f"(dispatches {token_mismatch[:8]}; {where})")
    del graph, eager
    torch.cuda.empty_cache()
    return result


def repeated_prompts(rng, vocab) -> list[list[int]]:
    """Two prompts built of repeated n-grams, so prompt lookup drafts."""
    a = rng.integers(0, vocab, 6).tolist()
    b = rng.integers(0, vocab, 11).tolist()
    return [a * 16, b * 9]


async def spec_leg(dtype, k, prompts, max_tokens) -> dict:
    """One llama3.2-1b engine in ``dtype`` with ``speculative_k=k``, warmed
    up, serving ``prompts``: its streams, launches by path, capture and
    the draft-verify spans it issued."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    engine = TorchEngine(full_width_config(speculative_k=k, dtype=dtype), device=DEVICE)
    await engine.start()
    try:
        capture = await warm_up(engine)
        recorded = record_dispatches(engine.runner)
        reset_counts()
        d0 = engine.unified_dispatches
        streams, _, _, wall = await serve(engine, prompts, max_tokens)
        recorded.stop()
        capture["mid_traffic_compiles_total"] = mid_traffic(engine)
        ready = engine.readiness()
        return {
            "streams": streams, "params": engine.runner.params,
            "dispatches": engine.unified_dispatches - d0, "wall_s": wall,
            "kernel_launches": fn.launches,
            "paths": {"tc": fn.launches_tc, "split": fn.launches_split,
                      "walk": fn.launches_walk},
            "capture": capture,
            "verify_rows": [1 + dl for _, _, dls, _ in recorded.calls
                            for dl in (dls or []) if dl],
            "drafted_tokens": ready["spec_drafted_tokens_total"],
            "accepted_tokens": ready["spec_accepted_tokens_total"],
            "tokens_per_step": ready["spec_tokens_per_step"],
            "spec_active_at_end": ready["spec_active"],
        }
    finally:
        await engine.stop()


async def phase_spec(prompts, max_tokens) -> dict:
    """A speculative_k=4 engine against a speculative_k=0 one on the same
    weights and prompts, in float32 and in bf16. Greedy decoding is
    batch-invariant only up to rounding: speculation changes how tokens
    are batched (the verify rows, pipeline depth 1), so a near tie in the
    logits can fall either way. In float32 a tie within rounding is rare
    enough that the streams must be byte-identical; in bf16 (ulp 0.0039
    at these logits, median top-two gap 0.023 nats) both engines' streams
    are held to the no-cache reference instead: agreement >=
    PHASES_AGREEMENT, every disagreement a near tie. Both legs: drafts
    accepted, every ragged call launched on its dtype's paths (bf16: tile
    and split; float32: walk and split), verify spans of 2-5 rows."""
    k = 4
    cfg = full_width_config().model
    L = cfg.num_layers
    result = {"phase": "spec", "model": cfg.name, "speculative_k": k,
              "requests": len(prompts), "max_tokens": max_tokens}
    failures = []
    for dtype, long_path in (("float32", "walk"), ("bfloat16", "tc")):
        legs = {kk: await spec_leg(dtype, kk, prompts, max_tokens) for kk in (0, k)}
        spec, plain = legs[k], legs[0]
        rows = spec.pop("verify_rows")
        plain.pop("verify_rows")
        identical = spec["streams"] == plain["streams"]
        first_diff = next(((i, j) for i, (a, b) in enumerate(
            zip(spec["streams"], plain["streams"])) for j, (x, y) in enumerate(zip(a, b))
            if x != y), None)
        leg = {
            "streams_identical_to_speculative_k_0": identical,
            "token_match_rate_vs_speculative_k_0": match_rate(spec["streams"],
                                                              plain["streams"]),
            "first_difference": first_diff,
            "verify_span_rows": {str(r): rows.count(r) for r in sorted(set(rows))},
            **{key: spec[key] for key in ("drafted_tokens", "accepted_tokens",
                                          "tokens_per_step", "spec_active_at_end")},
        }
        params = spec.pop("params")
        plain.pop("params")
        if dtype == "bfloat16":
            for name, run in (("spec", spec), ("plain", plain)):
                ref = teacher_forced(cfg, params, prompts, run["streams"])
                leg[f"reference_{name}"] = {key: ref[key] for key in (
                    "greedy_agreement_vs_no_cache_reference",
                    "max_logprob_gap_at_disagreement")}
                if (ref["greedy_agreement_vs_no_cache_reference"] < PHASES_AGREEMENT
                        or ref["max_logprob_gap_at_disagreement"] > NEAR_TIE_NATS):
                    failures.append(f"{dtype} {name} streams vs the reference {ref}")
        elif not identical:
            failures.append(f"{dtype}: streams differ from speculative_k=0 at {first_diff}")
        for name, run in (("spec", spec), ("plain", plain)):
            run.pop("streams")
            leg[name] = run
            n = run["dispatches"]
            want = {"tc": 0, "split": L * n, "walk": 0, long_path: L * n}
            if run["kernel_launches"] != L * n or run["paths"] != want:
                failures.append(f"{dtype} {name}: ragged launches {run['kernel_launches']}, "
                                f"paths {run['paths']} for {n} dispatches")
            try:
                check_capture(f"spec {dtype} {name}", run["capture"])
            except SystemExit as exc:
                failures.append(str(exc))
        if not leg["accepted_tokens"] > 0 or not rows or not all(
                2 <= r <= k + 1 for r in rows):
            failures.append(f"{dtype}: accepted {leg['accepted_tokens']}, "
                            f"verify spans {rows[:16]}")
        result[dtype] = leg
    result["gates"] = {"float32": "streams byte-identical",
                       "bfloat16": {"agreement_min": PHASES_AGREEMENT,
                                    "gap_max": NEAR_TIE_NATS}}
    emit(result)
    if failures:
        fail("spec: " + "; ".join(failures))
    return result


def reference_logprobs(cfg, params, prompt, stream, freq=0.0, pres=0.0) -> dict:
    """The no-cache reference fed ``stream``: at each generated position
    the log-softmax of its logits after the penalties over the tokens
    generated before it; its log-probability of each stream token, its
    argmax agreement, and the widest gap at a disagreement."""
    from dynamo_tpu_torch.models import llama

    seq = torch.tensor(prompt + stream, device=DEVICE)
    logits = llama.reference_forward(cfg, params, seq)[len(prompt) - 1:-1].float()
    want = seq[len(prompt):].long()
    onehot = torch.nn.functional.one_hot(want, cfg.vocab_size).float()
    before = torch.cumsum(onehot, dim=0) - onehot             # counts before i
    lp = torch.log_softmax(logits - freq * before - pres * (before > 0).float(), -1)
    chosen = lp[torch.arange(len(stream), device=DEVICE), want]
    best, arg = lp.max(dim=-1)
    hit = arg == want
    return {"logprobs": chosen.tolist(), "agreement": float(hit.float().mean()),
            "max_gap": float((best - chosen)[~hit].max()) if bool((~hit).any()) else 0.0}


async def phase_extras(port, engine, tapped, prompts, max_tokens) -> dict:
    """Sampling extras through the OpenAI server, for two of the serve's
    prompts: a completion with ``logprobs``, the completion again with
    frequency/presence penalties (``logprobs`` too), and one chat with
    ``top_logprobs``. Every chosen-token logprob must match the no-cache
    reference's within FIRST_LOGPROB_TOL (bf16 logits); the plain streams,
    and apart from them the penalized ones against the penalized
    reference, must pass the teacher-forced gate of the serves (pooled
    agreement >= PHASES_AGREEMENT, every disagreement a near tie); a
    penalized stream must differ from its plain one."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    cfg, params = engine.cfg.model, engine.runner.params
    greedy = {"model": cfg.name, "temperature": 0, "max_tokens": max_tokens,
              "nvext": {"ignore_eos": True}}
    freq, pres = 1.5, 0.5
    chat = [{"role": "user", "content": "Paged attention keeps each sequence's keys "
             "and values in fixed blocks; a block table maps positions to blocks, "
             "so prefix caching can share the blocks of a common prompt."}]
    requests = []
    for i, p in enumerate(prompts):
        requests += [(f"logprobs_{i}", "/v1/completions", {"prompt": p, "logprobs": 5}),
                     (f"penalized_{i}", "/v1/completions", {
                         "prompt": p, "logprobs": 1, "frequency_penalty": freq,
                         "presence_penalty": pres})]
    requests.append(("chat_top_logprobs", "/v1/chat/completions",
                     {"messages": chat, "logprobs": True, "top_logprobs": 3}))
    saved = dict(tapped)
    reset_counts()
    d0 = engine.unified_dispatches
    runs, pooled = {}, {"plain": [0, 0, 0.0], "penalized": [0, 0, 0.0]}
    for name, path, body in requests:
        tapped.clear()
        resp = await fetch("127.0.0.1", port, "POST", path, {**greedy, **body})
        if resp.status != 200:
            fail(f"extras: {name} answered {resp.status}: {resp.body[:300]}")
        (prompt_ids, ids), = tapped.items()
        lp = resp.json()["choices"][0]["logprobs"]
        if path.endswith("chat/completions"):
            got = [e["logprob"] for e in lp["content"]]
            tops = [[t["logprob"] for t in e["top_logprobs"]] for e in lp["content"]]
        else:
            got = lp["token_logprobs"]
            tops = [list(t.values()) if t else [] for t in lp["top_logprobs"]]
        penalized = name.startswith("penalized")
        ref = reference_logprobs(cfg, params, list(prompt_ids), ids,
                                 *((freq, pres) if penalized else (0.0, 0.0)))
        err = max(abs(a - b) for a, b in zip(got, ref["logprobs"]))
        pool = pooled["penalized" if penalized else "plain"]
        pool[0] += round(ref["agreement"] * len(ids))
        pool[1] += len(ids)
        pool[2] = max(pool[2], ref["max_gap"])
        runs[name] = {"stream": ids, "tokens": len(ids), "logprobs_returned": len(got),
                      "top_per_token": sorted({len(t) for t in tops}),
                      "max_logprob_err_vs_reference": err,
                      "agreement_vs_reference": ref["agreement"],
                      "max_gap_at_disagreement": ref["max_gap"]}
    launches, dispatches = fn.launches, engine.unified_dispatches - d0
    tapped.clear()
    tapped.update(saved)
    differs = [runs[f"penalized_{i}"]["stream"] != runs[f"logprobs_{i}"]["stream"]
               for i in range(len(prompts))]
    agreement = {k: {"agreement": hit / n, "tokens": n, "max_gap": gap}
                 for k, (hit, n, gap) in pooled.items()}
    result = {
        "phase": "extras", "model": cfg.name, "max_tokens": max_tokens,
        "frequency_penalty": freq, "presence_penalty": pres,
        "penalized_streams_differ": differs, "pooled_vs_reference": agreement,
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "mid_traffic_compiles_total": mid_traffic(engine),
        "gates": {"logprob_err_max": FIRST_LOGPROB_TOL, "agreement_min": PHASES_AGREEMENT,
                  "gap_max": NEAR_TIE_NATS},
        **{name: {k: v for k, v in r.items() if k != "stream"} for name, r in runs.items()},
    }
    emit(result)
    # Completions key their alternatives by token text, and the toy
    # tokenizer decodes many ids to "", so up to k entries there.
    for name, r in runs.items():
        want_top = ([3] if name.startswith("chat") else [1] if name.startswith("pen")
                    else range(1, 6))
        if (r["tokens"] != max_tokens or r["logprobs_returned"] != max_tokens
                or not set(r["top_per_token"]) <= set(want_top)
                or r["max_logprob_err_vs_reference"] > FIRST_LOGPROB_TOL):
            fail(f"extras: {name} failed its gates: "
                             f"{ {k: v for k, v in r.items() if k != 'stream'} }")
    for kind, a in agreement.items():
        if a["agreement"] < PHASES_AGREEMENT or a["max_gap"] > NEAR_TIE_NATS:
            fail(f"extras: {kind} streams vs the reference {a}")
    # A stream with no repeated token is left as it was by the penalties;
    # one at least must show them at work.
    if not any(differs):
        fail(f"extras: the penalized streams equal the plain ones {differs}")
    if launches != cfg.num_layers * dispatches or not dispatches:
        fail(f"extras: kernel launched {launches} times for "
                         f"{dispatches} dispatches")
    if result["mid_traffic_compiles_total"]:
        fail("extras: a program was captured mid-traffic")
    return result


HTTP_ARGS = [
    "run", "--out", "torch", "--model-path", "preset:llama3.2-1b",
    "--num-blocks", "1024", "--max-num-seqs", "8", "--max-model-len", "1024",
    "--prefill-batch", "4", "--unified-token-budget", "256",
    "--unified-prefill-quantum", "64",
]


async def http_stream(port, path, body, on_event=None):
    """POST a streaming request; (response, [(seconds since send, event)])
    for every SSE event, timed as its chunk arrived. ``on_event(t, event)``
    sees each event as it arrives."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.protocols.sse import decode_stream

    timed = []
    t0 = time.perf_counter()

    def got(piece: bytes) -> None:
        t = time.perf_counter() - t0
        for ev in decode_stream(piece.decode()):
            timed.append((t, ev))
            if on_event is not None:
                on_event(t, ev)

    resp = await fetch("127.0.0.1", port, "POST", path, body, on_chunk=got)
    return resp, timed


def stream_summary(timed) -> dict:
    """Text, finish, usage and the token events' arrival times of a
    streamed completion."""
    text, finish, usage, times = "", None, None, []
    for t, ev in timed:
        if ev.data == "[DONE]":
            continue
        chunk = json.loads(ev.data)
        if "error" in chunk:
            fail(f"http: stream error {chunk}")
        for ch in chunk.get("choices", []):
            times.append(t)
            text += ch.get("text") or ""
            finish = ch.get("finish_reason") or finish
        usage = chunk.get("usage") or usage
    return {"text": text, "finish": finish, "usage": usage, "times": times}


async def phase_http(prompts, serve_streams, max_tokens, served, more_prompts) -> dict:
    """The main path through the OpenAI server: see the module docstring
    (phase 7)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.tokenizer import (
        ToyTokenizer,
        render_default_chat_template,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.pipeline import Tap

    args = cli.build_parser().parse_args(
        HTTP_ARGS + ["--http-host", "127.0.0.1", "--http-port", "0"])
    cli.refuse_unserved(args)
    tapped: dict[tuple, list[int]] = {}   # prompt token ids -> engine tokens
    tap = Tap(
        on_request=lambda ctx: tapped.setdefault(tuple(ctx.payload["token_ids"]), []),
        on_response=lambda ctx, item: tapped[tuple(ctx.payload["token_ids"])].extend(
            item["token_ids"]),
    )
    rng = np.random.default_rng(2)
    words = ["alpha", "beta", "gamma", "delta", "kernel", "cache", "token", "page"]
    chats = [[{"role": "user", "content": " ".join(rng.choice(words, 12))}]
             for _ in range(2)]
    greedy = {"temperature": 0, "max_tokens": max_tokens, "nvext": {"ignore_eos": True}}
    async with contextlib.AsyncExitStack() as stack:
        t_start = time.monotonic()
        service, engine = await cli.start_http(args, stack, engine_ops=(tap,))
        startup_s = time.monotonic() - t_start
        port = service.port
        cfg = engine.cfg.model
        reset_counts()
        d0 = engine.unified_dispatches
        t0 = time.perf_counter()
        streamed = await asyncio.gather(*[
            http_stream(port, "/v1/completions",
                        {"model": cfg.name, "prompt": p, "stream": True, **greedy})
            for p in prompts])
        wall = time.perf_counter() - t0
        aggregated = await asyncio.gather(*[
            fetch("127.0.0.1", port, "POST", "/v1/chat/completions",
                  {"model": cfg.name, "messages": m, **greedy}) for m in chats])
        launches = fn.launches
        paths = {"tc": fn.launches_tc, "split": fn.launches_split,
                 "walk": fn.launches_walk}
        dispatches = engine.unified_dispatches - d0
        gets = {path: await fetch("127.0.0.1", port, "GET", path)
                for path in ("/v1/models", "/health", "/metrics")}
        await phase_extras(port, engine, tapped, more_prompts, max_tokens)

        # Drain with one request in flight: it completes, a new one is
        # refused with 503, as the CLI drains on SIGTERM.
        inflight = asyncio.create_task(http_stream(
            port, "/v1/completions",
            {"model": cfg.name, "prompt": prompts[0], "stream": True, **greedy}))
        while not tapped.get(tuple(prompts[0])) or len(
                tapped[tuple(prompts[0])]) <= max_tokens:
            await asyncio.sleep(0.005)
        drain = asyncio.create_task(service.drain(60.0))
        await asyncio.sleep(0)
        refused = await fetch("127.0.0.1", port, "POST", "/v1/completions",
                              {"model": cfg.name, "prompt": [1, 2, 3], **greedy})
        drained_resp, drained_timed = await inflight
        service_drained = await drain
        engine.begin_drain()
        engine_drained = await engine.wait_drained(60.0)
        params = engine.runner.params

    statuses = ([r.status for r, _ in streamed] + [r.status for r in aggregated]
                + [r.status for r in gets.values()])
    summaries = [stream_summary(timed) for _, timed in streamed]
    tok = ToyTokenizer()
    http_streams, texts_ok = [], True
    for p, summ in zip(prompts, summaries):
        ids = tapped[tuple(p)][:max_tokens]
        http_streams.append(ids)
        stepper = tok.decode_stream()
        incremental = "".join(piece for piece in map(stepper.step, ids) if piece)
        texts_ok &= summ["text"] == incremental
    chat_prompts = [tok.encode(render_default_chat_template(
        [{"role": m[0]["role"], "content": m[0]["content"]}])) for m in chats]
    chat_streams = [tapped[tuple(p)] for p in chat_prompts]
    counts_ok = (
        all(s["usage"]["completion_tokens"] == max_tokens and s["finish"] == "length"
            and len(s["times"]) == max_tokens for s in summaries)
        and all(r.json()["usage"]["completion_tokens"] == max_tokens
                and r.json()["choices"][0]["finish_reason"] == "length"
                for r in aggregated)
        and all(len(s) == max_tokens for s in http_streams + chat_streams)
    )
    ref = teacher_forced(cfg, params, list(prompts) + chat_prompts,
                         http_streams + chat_streams)
    ref.pop("first_token_ref_logprob")
    ttft = [s["times"][0] for s in summaries]
    itl = [b - a for s in summaries for a, b in zip(s["times"], s["times"][1:])]
    drained = stream_summary(drained_timed)
    metrics_text = gets["/metrics"].body.decode()
    result = {
        "phase": "http", "model": cfg.name, "dtype": engine.cfg.dtype,
        "server_startup_s": startup_s, "requests_streamed": len(prompts),
        "requests_aggregated": len(chats), "max_tokens": max_tokens,
        "statuses": statuses, "wall_s": wall,
        "tokens_per_s": len(prompts) * max_tokens / wall,
        "client_ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "client_ttft_max_ms": max(ttft) * 1e3,
        "client_itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
        "client_itl_p95_ms": float(np.percentile(itl, 95)) * 1e3,
        "in_process_serve": {"ttft_p50_ms": served["ttft_p50_ms"],
                             "ttft_max_ms": served["ttft_max_ms"],
                             "wall_s": served["wall_s"],
                             "tokens_per_s": served["tokens_per_s"]},
        "http_minus_in_process_ttft_p50_ms":
            float(np.median(ttft)) * 1e3 - served["ttft_p50_ms"],
        "http_minus_in_process_wall_ms_per_request":
            (wall - served["wall_s"]) * 1e3 / len(prompts),
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "kernel_launches_by_path": paths, "num_layers": cfg.num_layers,
        "counts_ok": counts_ok, "streamed_text_is_incremental_toy_decode": texts_ok,
        "greedy_match_rate_vs_serve": match_rate(http_streams, serve_streams),
        **ref, "gates": {"agreement_min": PHASES_AGREEMENT, "gap_max": NEAR_TIE_NATS},
        "models": [m["id"] for m in gets["/v1/models"].json()["data"]],
        "metrics_has_requests_total":
            "dyntpu_http_service_requests_total" in metrics_text,
        "metrics_has_capture_gauges": all(
            f"dyntpu_http_service_{k}" in metrics_text
            for k in ("warmed_programs", "mid_traffic_compiles_total")),
        "capture": {**engine.runner.compile_stats.capture_snapshot(),
                    "mid_traffic_compiles_total": mid_traffic(engine)},
        "drain": {"inflight_status": drained_resp.status,
                  "inflight_tokens": drained["usage"]["completion_tokens"],
                  "refused_status": refused.status,
                  "service_drained": service_drained,
                  "engine_drained": engine_drained},
    }
    result["batch_cli"] = batch_cli(max_tokens=16)
    emit(result)
    result["streams"] = http_streams
    if any(code != 200 for code in statuses) or result["models"] != [cfg.name]:
        fail(f"http: statuses {statuses}, models {result['models']}")
    if not (counts_ok and texts_ok and result["metrics_has_requests_total"]
            and result["metrics_has_capture_gauges"]):
        fail("http: token counts, finish reasons, streamed text or "
                         "/metrics wrong")
    if result["capture"]["mid_traffic_compiles_total"] or not result["capture"][
            "graphs_captured"]:
        fail(f"http: capture {result['capture']}")
    if launches != cfg.num_layers * dispatches or dispatches == 0:
        fail(f"http: kernel launched {launches} times for {dispatches} "
                         f"dispatches x {cfg.num_layers} layers")
    if paths != {"tc": launches, "split": launches, "walk": 0}:
        fail(f"http: ragged paths launched {paths} for {launches} calls")
    if not (ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
        fail("http: streams disagree with the no-cache reference")
    d = result["drain"]
    if (d["inflight_status"], d["inflight_tokens"], d["refused_status"]) != (
            200, max_tokens, 503) or not (d["service_drained"] and d["engine_drained"]):
        fail(f"http: drain {d}")
    return result


def batch_cli(max_tokens: int) -> dict:
    """``python -m dynamo_tpu_torch run --in batch:FILE --out torch`` in a
    subprocess, 4 prompts; returns its JSON report."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.txt")
        with open(path, "w") as f:
            f.write("hello there\nwhat is a kernel\npaged attention\nthe end\n")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch", *HTTP_ARGS, "--in",
             f"batch:{path}", "--max-tokens", str(max_tokens)],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        fail(f"batch CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    report = json.loads(lines[-1])
    if report["requests"] != 4 or not report["tokens_out_per_s"] > 0:
        fail(f"batch CLI report {report}")
    return {"report": report, "process_s": time.monotonic() - t0}


# -- phase 7b: observe ---------------------------------------------------------
OBSERVE_STREAMS = 4          # interactive streams per leg
OBSERVE_PROMPT = 64          # their prompt tokens
OBSERVE_TOKENS = 192         # their greedy tokens
OBSERVE_BURST = (4, 896, 8)  # batch prompts mid-decode: count, tokens, output
OBSERVE_QUANTUM = 256        # the static leg's quantum, the adaptive leg's start
OBSERVE_SLO_X = 1.5          # itl_slo_ms = this × the decode-only leg's ITL EMA
OBSERVE_TIGHT_X = 1.1        # the tight leg's SLO = this × the decode-only EMA
RAGGED_SYMBOLS = (b"ragged_tc_kernel", b"ragged_split_kernel")


class NullTracer:
    """Stands in for the process tracer while the A/B measures the serve
    with tracing off: every call the engine makes is a no-op."""

    abandoned_total = 0

    def __getattr__(self, name):
        return lambda *a, **kw: None

    @contextlib.contextmanager
    def span(self, *_a):
        yield


class NullFlight:
    """Stands in for the engine's flight recorder in the same A/B."""

    total_steps = 0

    def note_step(self, *_a, **_kw) -> None:
        pass


async def observe_stream(port, body, headers, events):
    """POST a streaming /v1/completions; each SSE token event is appended
    to ``events`` as (perf_counter seconds, text) as it arrives. Returns
    the response."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.protocols.sse import decode_stream

    def got(piece: bytes) -> None:
        t = time.perf_counter()
        for ev in decode_stream(piece.decode()):
            if ev.data == "[DONE]":
                continue
            chunk = json.loads(ev.data)
            if "error" in chunk:
                fail(f"observe: stream error {chunk}")
            for ch in chunk.get("choices", []):
                events.append((t, ch.get("finish_reason")))

    return await fetch("127.0.0.1", port, "POST", "/v1/completions", body, headers,
                       on_chunk=got)


async def observe_leg(port, model, prompts, burst, tapped, tokens=None,
                      during_burst=None) -> dict:
    """One leg: OBSERVE_STREAMS interactive streams; once each has 32
    tokens, the batch burst (if any) is sent and ``during_burst()``
    (if any) runs beside it. Client ITL of the streams over the whole
    leg and over the burst window (burst sent → last burst response)."""
    tapped.clear()
    tokens = tokens or OBSERVE_TOKENS
    greedy = {"temperature": 0, "stream": True, "nvext": {"ignore_eos": True}}
    events = [[] for _ in prompts]
    interactive = {"X-Request-Class": "interactive"}
    streams = [asyncio.create_task(observe_stream(
        port, {"model": model, "prompt": p, "max_tokens": tokens, **greedy},
        interactive, ev)) for p, ev in zip(prompts, events)]
    extra = None
    t_burst = t_done = None
    if burst:
        while min(len(ev) for ev in events) < 32:
            if any(s.done() for s in streams):
                fail("observe: a stream ended before the burst")
            await asyncio.sleep(0.001)
        t_burst = time.perf_counter()
        burst_events = [[] for _ in burst]
        sent = [observe_stream(
            port, {"model": model, "prompt": p, "max_tokens": OBSERVE_BURST[2], **greedy},
            {"X-Request-Class": "batch"}, ev) for p, ev in zip(burst, burst_events)]
        side = [during_burst()] if during_burst is not None else []
        *burst_resps, extra = await asyncio.gather(*sent, *(side or [_none()]))
        t_done = time.perf_counter()
    resps = await asyncio.gather(*streams)
    statuses = [r.status for r in resps] + ([r.status for r in burst_resps] if burst else [])
    if any(c != 200 for c in statuses):
        fail(f"observe: statuses {statuses}")
    gaps_all, gaps_burst = [], []
    for ev in events:
        times = [t for t, _ in ev]
        for a, b in zip(times, times[1:]):
            gaps_all.append(b - a)
            if burst and t_burst <= b <= t_done:
                gaps_burst.append(b - a)
    out = {
        "statuses": statuses,
        "tokens": [len(ev) for ev in events],
        "itl_p50_ms": float(np.percentile(gaps_all, 50)) * 1e3,
        "itl_p95_ms": float(np.percentile(gaps_all, 95)) * 1e3,
        "streams": [list(tapped.get(tuple(p), [])) for p in prompts],
    }
    if burst:
        out.update({
            "burst_window_ms": (t_done - t_burst) * 1e3,
            "burst_itl_p50_ms": float(np.percentile(gaps_burst, 50)) * 1e3,
            "burst_itl_p95_ms": float(np.percentile(gaps_burst, 95)) * 1e3,
            "burst_itl_max_ms": max(gaps_burst) * 1e3,
            "burst_gaps": len(gaps_burst),
            "burst_streams": [list(tapped.get(tuple(p), [])) for p in burst],
            "burst_tokens": [len(ev) for ev in burst_events],
        })
    return out, extra


async def _none():
    return None


def quantum_trajectory(steps: list) -> list:
    """Run-length form of the flight records' quantum: [quantum, steps]."""
    out = []
    for rec in steps:
        if rec.get("kind") not in ("unified", "spec"):
            continue
        if out and out[-1][0] == rec["quantum"]:
            out[-1][1] += 1
        else:
            out.append([rec["quantum"], 1])
    return out


async def tracing_ab(engine, prompts, max_tokens) -> dict:
    """The serve profile's wall ms per dispatch with the tracer and the
    flight recorder on, and with both swapped for no-op stand-ins, in
    turns (on, off, on, off) on one engine."""
    from dynamo_tpu_torch.utils import tracing

    runs = []
    for on in (True, False, True, False):
        saved_tracer, saved_flight = tracing._default, engine.flight
        if not on:
            tracing._default, engine.flight = NullTracer(), NullFlight()
        try:
            prof = await profile_serve(engine, prompts, max_tokens)
        finally:
            tracing._default, engine.flight = saved_tracer, saved_flight
        runs.append({"on": on, "wall_ms_per_dispatch": prof["wall_ms_per_dispatch"],
                     "device_ms_per_dispatch": prof["device_ms_per_dispatch"],
                     "dispatches": prof["dispatches"]})
    on_ms = [r["wall_ms_per_dispatch"] for r in runs if r["on"]]
    off_ms = [r["wall_ms_per_dispatch"] for r in runs if not r["on"]]
    return {"runs": runs, "on_mean_ms": float(np.mean(on_ms)),
            "off_mean_ms": float(np.mean(off_ms)),
            "tracing_cost_ms_per_dispatch": float(np.mean(on_ms) - np.mean(off_ms))}


def scan_trace(path: str, engine_tid: int) -> dict:
    """The profile window's Chrome trace: bytes, the ragged kernel's
    symbols found, device kernel events, and CPU ops on the engine
    thread."""
    with open(path, "rb") as f:
        raw = f.read()
    doc = json.loads(raw)
    events = doc.get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ragged = [e for e in kernels if e.get("name", "").find("ragged_") >= 0]
    engine_ops = [e for e in events if e.get("cat") == "cpu_op"
                  and e.get("tid") == engine_tid]
    return {"trace_bytes": len(raw),
            "ragged_symbols": [s.decode() for s in RAGGED_SYMBOLS if s in raw],
            "kernel_events": len(kernels), "ragged_kernel_events": len(ragged),
            "cpu_op_events": sum(1 for e in events if e.get("cat") == "cpu_op"),
            "engine_thread_cpu_ops": len(engine_ops),
            "engine_thread_op_names": sorted({e["name"] for e in engine_ops})[:6],
            "event_categories": dict(collections.Counter(
                str(e.get("cat")) for e in events).most_common(8))}


def metric_value(text: str, name: str) -> float | None:
    """One gauge of the OpenAI server's /metrics text."""
    for line in text.splitlines():
        if line.startswith(f"dyntpu_http_service_{name} "):
            return float(line.split()[1])
    return None


async def watch_quantum_fall(engine, start: int, stop: asyncio.Event) -> dict:
    """Poll the controller every 2 ms until ``stop``: the violation count
    at the first sample whose quantum is below ``start``. The quantum is
    read before the count: the controller counts a sample's violation
    before it adapts, so a fall seen here has its cause counted."""
    coloc = engine.coloc
    v0 = coloc.itl_slo_violations_total
    while not stop.is_set():
        q = coloc.quantum
        v = coloc.itl_slo_violations_total
        if q < start:
            return {"violations_at_start": v0, "violations_at_first_fall": v,
                    "first_fall_quantum": q}
        await asyncio.sleep(0.002)
    return {"violations_at_start": v0, "violations_at_first_fall": None,
            "first_fall_quantum": None}


async def observe_adaptive_leg(port, engine, model, prompts, burst, tapped, slo,
                               name) -> dict:
    """The burst leg on an adaptive server; its flight records give the
    quantum trajectory and the compose-time EMA, a 2 ms poll of the
    controller whether its violation count rose before the quantum first
    fell."""
    from dynamo_tpu_torch.llm.http_client import fetch

    last = engine.debug_steps(1)
    seq0 = last[-1]["seq"] if last else 0
    stop = asyncio.Event()
    watch = asyncio.ensure_future(watch_quantum_fall(engine, engine.coloc.quantum, stop))
    try:
        leg, _ = await observe_leg(port, model, prompts, burst, tapped)
    finally:
        stop.set()
    fall = await watch
    steps = (await fetch("127.0.0.1", port, "GET", "/debug/steps?n=1024")).json()["steps"]
    recs = [r for r in steps if r["seq"] > seq0 and r["kind"] in ("unified", "spec")]
    ready = engine.readiness()
    leg.update({
        "itl_slo_ms": slo,
        "quantum_trajectory": quantum_trajectory(recs),
        "flight_records": len(recs),
        "ema_first_ms": recs[0]["itl_ema_ms"],
        "ema_peak_ms": max(r["itl_ema_ms"] for r in recs),
        "ema_crossed_slo": any(r["itl_ema_ms"] > slo for r in recs),
        **fall,
        "violations_before_first_fall": (
            fall["violations_at_first_fall"] is not None
            and fall["violations_at_first_fall"] > fall["violations_at_start"]),
        "coloc": {k: ready[k] for k in (
            "coloc_quantum", "itl_ema_ms", "itl_p95_ms", "itl_slo_violations_total",
            "coloc_prefill_deferrals_total")},
    })
    emit({"phase": "observe_leg", "leg": name, **{
        k: v for k, v in leg.items() if "streams" not in k}})
    return leg


async def phase_observe(vocab: int) -> dict:
    """Tracing, the flight recorder, deadlines, SLO classes, the
    adaptive co-location controller and the profile window on the OpenAI
    server at full width: see the module docstring (phase 7b)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.pipeline import Tap
    from dynamo_tpu_torch.tools import trace_merge
    from dynamo_tpu_torch.utils.tracing import reset_tracer

    t_phase = time.monotonic()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, OBSERVE_PROMPT).tolist()
               for _ in range(OBSERVE_STREAMS)]
    burst = [rng.integers(0, vocab, OBSERVE_BURST[1]).tolist()
             for _ in range(OBSERVE_BURST[0])]
    ab_prompts = [rng.integers(0, vocab, n).tolist() for n in rng.integers(64, 513, 8)]
    tapped: dict[tuple, list[int]] = {}
    tap = Tap(
        on_request=lambda ctx: tapped.setdefault(tuple(ctx.payload["token_ids"]), []),
        on_response=lambda ctx, item: tapped[tuple(ctx.payload["token_ids"])].extend(
            item["token_ids"]),
    )
    base = HTTP_ARGS[:-1] + [str(OBSERVE_QUANTUM), "--http-host", "127.0.0.1",
                             "--http-port", "0"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    capture = os.path.join(tmp, "trace.jsonl")
    profile_dir = os.path.join(tmp, "profiles")
    reset_tracer(capture)
    result: dict = {"phase": "observe"}
    legs: dict = {}
    checks = []                    # (server, flight records, dispatches)
    launches = dispatches = 0
    mid = {}

    async def start(extra, stack):
        args = cli.build_parser().parse_args(base + extra)
        cli.refuse_unserved(args)
        service, engine = await cli.start_http(args, stack, engine_ops=(tap,))
        reset_counts()
        return service.port, engine, engine.unified_dispatches, engine.flight.total_steps

    try:
        # Server A, --coloc static (quantum 256): step 1 measures the
        # decode ITL the SLO is set from; the burst leg is the control;
        # step 4's A/B runs on the same engine.
        async with contextlib.AsyncExitStack() as stack:
            port, engine, d0, f0 = await start(["--coloc", "static"], stack)
            model, cfg, params = engine.cfg.model.name, engine.cfg.model, engine.runner.params
            legs["decode_only"], _ = await observe_leg(port, model, prompts, None, tapped)
            emit({"phase": "observe_leg", "leg": "decode_only", **{
                k: v for k, v in legs["decode_only"].items() if "streams" not in k}})
            decode_p50 = legs["decode_only"]["itl_p50_ms"]
            # The controller holds its own ITL EMA (one sample per retired
            # dispatch) to the SLO, so the SLO is set in those units: the
            # client's gaps coalesce whenever this process's loop falls
            # behind (one run read a p50 of 0.047 ms beside an EMA of 3.7,
            # and the leg starved its streams at an SLO of 0.07 ms).
            decode_ema = engine.coloc.snapshot()["itl_ema_ms"]
            slo = OBSERVE_SLO_X * decode_ema
            # From here the static controller measures against that SLO,
            # as `--coloc static --itl-slo-ms` would have from the start
            # (a static quantum never moves).
            engine.coloc.slo_ms = slo
            legs["static"] = await observe_adaptive_leg(
                port, engine, model, prompts, burst, tapped, slo, "static")
            mid["static"] = mid_traffic(engine)
            checks.append(("static", engine.flight.total_steps - f0,
                           engine.unified_dispatches - d0))
            # Step 4 (its "off" runs swap the flight recorder out, so the
            # record-per-dispatch check is taken before it).
            result["tracing_ab"] = await tracing_ab(engine, ab_prompts, 32)
            launches += fn.launches
            dispatches += engine.unified_dispatches - d0
        # A tight SLO in the controller's own units: 10% above its EMA of
        # the decode-only leg (where the static burst leg began). At 1.5 x
        # the decode ITL a 256-row dispatch may never pressure the SLO;
        # a burst of them pressures this one and steady decode does not,
        # so this leg shows the controller under pressure either way.
        slo_tight = OBSERVE_TIGHT_X * legs["static"]["ema_first_ms"]
        emit({"phase": "observe_slo", "decode_itl_p50_ms": decode_p50,
              "decode_only_ema_ms": decode_ema, "itl_slo_ms": slo,
              "decode_ema_ms": legs["static"]["ema_first_ms"],
              "static_ema_peak_ms": legs["static"]["ema_peak_ms"],
              "itl_slo_tight_ms": slo_tight})
        # Server B, --coloc adaptive --itl-slo-ms 1.5 x decode ITL.
        async with contextlib.AsyncExitStack() as stack:
            port, engine, d0, f0 = await start(
                ["--coloc", "adaptive", "--itl-slo-ms", f"{slo:.4f}"], stack)
            legs["adaptive"] = await observe_adaptive_leg(
                port, engine, model, prompts, burst, tapped, slo, "adaptive")
            mid["adaptive"] = mid_traffic(engine)
            checks.append(("adaptive", engine.flight.total_steps - f0,
                           engine.unified_dispatches - d0))
            launches += fn.launches
            dispatches += engine.unified_dispatches - d0
        # Server C, --coloc adaptive at the tighter SLO, with the profile
        # directory; then step 3 under the same traffic.
        async with contextlib.AsyncExitStack() as stack:
            port, engine, d0, f0 = await start(
                ["--coloc", "adaptive", "--itl-slo-ms", f"{slo_tight:.4f}",
                 "--profile-dir", profile_dir], stack)
            legs["adaptive_tight"] = await observe_adaptive_leg(
                port, engine, model, prompts, burst, tapped, slo_tight, "adaptive_tight")
            m0 = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()

            # The deadline probe needs every slot running, which the tight
            # SLO never lets happen (the controller holds the burst's
            # prompts in waiting, deferral by deferral): this leg runs
            # with the SLO off, so the controller admits every prompt and
            # holds its quantum (the tight leg's floor, which keeps the
            # burst prefilling for dozens of dispatches).
            engine.coloc.slo_ms = 0.0

            async def during_burst():
                # Send once every slot is running (read from the engine)
                # and none of the running sequences is within 3 tokens of
                # its end: the 1 ms request then waits for a slot that
                # frees 2+ dispatches later, and expires in the waiting
                # list before any output. (Running plus waiting filling
                # the slots left one free: the request could take it and
                # reach its first token within the millisecond.)
                t0 = time.monotonic()
                while True:
                    running = list(engine.scheduler.running.values())
                    if (len(running) == engine.cfg.max_num_seqs
                            and all(len(q.output_tokens) + 3 <= q.stop.max_tokens
                                    for q in running)):
                        break
                    if time.monotonic() - t0 > 10.0:
                        fail("observe: the burst never filled the slots")
                    await asyncio.sleep(0.0002)
                late = await fetch("127.0.0.1", port, "POST", "/v1/completions", {
                    "model": model, "prompt": prompts[0][::-1], "max_tokens": 8,
                    "temperature": 0}, {"X-Request-Timeout-Ms": "1"})
                prof = asyncio.create_task(fetch(
                    "127.0.0.1", port, "GET", "/debug/profile?seconds=1"))
                # Keep the engine dispatching until the window closes: the
                # profiler's start holds the loop for a time that varies
                # from call to call, and the burst can end before it opens.
                # Two requests at a time, each followed by a pause: back to
                # back they kept the engine dispatching all through the
                # window, whose trace then held ~5x the events and took
                # ~20 s longer to export. Their statuses are reported.
                async def keep_busy(i):
                    while not prof.done():
                        r = await fetch("127.0.0.1", port, "POST", "/v1/completions", {
                            "model": model, "prompt": prompts[1 + i][::-1],
                            "max_tokens": 16, "temperature": 0})
                        busy[r.status] = busy.get(r.status, 0) + 1
                        await asyncio.sleep(0.5)

                await asyncio.gather(keep_busy(0), keep_busy(1))
                return late, await prof

            busy: dict[int, int] = {}   # statuses of the window's filler requests
            legs["deadline_profile"], (late, prof) = await observe_leg(
                port, model, prompts, burst, tapped, tokens=96,
                during_burst=during_burst)
            m1 = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()
            body = late.json()
            choice = (body.get("choices") or [{}])[0]
            result["deadline"] = {
                "status": late.status,
                "error_type": (body.get("error") or {}).get("type"),
                "finish_reason": choice.get("finish_reason"),
                "completion_tokens": (body.get("usage") or {}).get("completion_tokens"),
                "deadline_exceeded_total_delta":
                    metric_value(m1, "deadline_exceeded_total")
                    - metric_value(m0, "deadline_exceeded_total"),
            }
            result["metrics_has"] = {k: metric_value(m1, k) is not None for k in (
                "itl_slo_violations_total", "deadline_exceeded_total",
                "shed_interactive_total", "shed_batch_total", "coloc_quantum",
                "flight_steps_total")} | {
                "trace_histograms": "dyntpu_trace_itl_ms_bucket" in m1}
            profile = prof.json()
            result["profile"] = {"status": prof.status, "filler_statuses": busy, **{
                k: profile.get(k) for k in ("seconds", "device_events")}}
            if prof.status == 200:
                result["profile"].update(scan_trace(profile["trace"],
                                                    engine._thread.native_id))
            mid["adaptive_tight"] = mid_traffic(engine)
            checks.append(("adaptive_tight", engine.flight.total_steps - f0,
                           engine.unified_dispatches - d0))
            launches += fn.launches
            dispatches += engine.unified_dispatches - d0
        reset_tracer(None)
        merged = trace_merge.merge_report(trace_merge.load_captures([capture]))
        result["trace_merge"] = {
            "completed_requests": merged["completed_requests"],
            "orphan_traces": len(merged["orphan_traces"]),
            "incomplete": len(merged["incomplete"]),
            "ttft_decomposition_p50_ms": {
                k: v["p50_ms"] for k, v in merged["ttft_decomposition_ms"].items()},
        }
        with contextlib.redirect_stdout(io.StringIO()):   # its report, printed in full
            result["trace_merge"]["assert_complete_exit"] = trace_merge.main(
                [capture, "--assert-complete"])
    finally:
        reset_tracer(None)
        shutil.rmtree(tmp, ignore_errors=True)
    # Every burst leg's streams held to the no-cache reference (the same
    # seed gives the three servers the same weights).
    ref_prompts, ref_streams = [], []
    full = True
    for name in ("decode_only", "static", "adaptive", "adaptive_tight"):
        leg = legs[name]
        ref_prompts += prompts
        ref_streams += leg["streams"]
        full &= all(len(s) == OBSERVE_TOKENS for s in leg["streams"])
        if "burst_streams" in leg:
            ref_prompts += burst
            ref_streams += leg["burst_streams"]
            full &= all(len(s) == OBSERVE_BURST[2] for s in leg["burst_streams"])
    ref = teacher_forced(cfg, params, ref_prompts, ref_streams)
    ref.pop("first_token_ref_logprob")
    for leg in legs.values():
        leg.pop("streams")
        leg.pop("burst_streams", None)
    result.update({
        "legs": legs, "streams_full_length": full, **ref,
        "mid_traffic_compiles_total": mid, "kernel_launches": launches,
        "unified_dispatches": dispatches, "flight_checks": checks,
        "num_layers": cfg.num_layers, "wall_s": time.monotonic() - t_phase,
    })
    emit(result)
    if not (full and ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
        fail("observe: streams short or disagreeing with the reference")
    if any(mid.values()):
        fail(f"observe: graphs captured mid-traffic {mid}")
    # The controller's contract on every leg: the quantum starts at 256
    # and never goes below the floor; the static one never moves; an
    # adaptive one falls only after a sample over its SLO was counted
    # (itl_slo_violations_total rose before the first fall: the EMA can
    # pass the SLO only after such a sample). The flight records' EMA is
    # taken at compose and can miss a crossing between two records, so
    # its peak is reported, not gated. The tight leg must move.
    for name in ("static", "adaptive", "adaptive_tight"):
        leg = legs[name]
        traj = [q for q, _ in leg["quantum_trajectory"]]
        moved = min(traj) < OBSERVE_QUANTUM
        if name == "static":
            ok = not moved
        else:
            ok = not moved or leg["violations_before_first_fall"]
        if not traj or traj[0] != OBSERVE_QUANTUM or min(traj) < 16 or not ok:
            fail(
                f"observe: {name} quantum trajectory {leg['quantum_trajectory']} "
                f"(violations at start {leg['violations_at_start']}, at the first "
                f"fall {leg['violations_at_first_fall']}; compose-time EMA crossed "
                f"the SLO: {leg['ema_crossed_slo']}, peak {leg['ema_peak_ms']} ms)")
    if min(q for q, _ in legs["adaptive_tight"]["quantum_trajectory"]) >= OBSERVE_QUANTUM:
        fail("observe: the tight SLO was never pressured")
    if any(f != d for _, f, d in checks) or not dispatches:
        fail(f"observe: flight records vs dispatches {checks}")
    if result["trace_merge"]["assert_complete_exit"] != 0 or result["trace_merge"][
            "orphan_traces"]:
        fail(f"observe: trace merge {result['trace_merge']}")
    # The 1 ms deadline expires in the waiting list, before any output:
    # 504, counted once.
    d = result["deadline"]
    if ((d["status"], d["error_type"]) != (504, "deadline_exceeded")
            or d["deadline_exceeded_total_delta"] != 1.0):
        fail(f"observe: deadline {d}")
    if result["profile"]["status"] != 200 or not result["profile"].get("ragged_symbols"):
        fail(f"observe: profile {result['profile']}")
    if not all(result["metrics_has"].values()):
        fail(f"observe: /metrics {result['metrics_has']}")
    if launches != cfg.num_layers * dispatches:
        fail(f"observe: kernel launched {launches} times for "
                         f"{dispatches} dispatches x {cfg.num_layers} layers")
    return result


def phase_phases(params, prompts, unified_streams, max_tokens, ecfg=None,
                 phase="phases") -> dict:
    """The phase-split entry points at full width on the serve's weights
    (``ecfg``: the serve's engine settings, llama3.2-1b's by default),
    each kernel's launches counted over exactly this run."""
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
        paged_decode_attention_cuda,
    )
    from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
        paged_prefill_attention_cuda,
    )

    ecfg = ecfg or full_width_config()
    runner = ModelRunner(ecfg, params=params, device=DEVICE)
    paged_prefill_attention_cuda.launches = 0
    paged_prefill_attention_cuda.launches_tc = 0
    paged_decode_attention_cuda.launches = 0
    streams, times = phase_split(runner, prompts, max_tokens)
    streams = [s[:max_tokens] for s in streams]
    prefill_launches = paged_prefill_attention_cuda.launches
    prefill_launches_tc = paged_prefill_attention_cuda.launches_tc
    decode_launches = paged_decode_attention_cuda.launches
    L = ecfg.model.num_layers
    in_vocab = all(0 <= t < ecfg.model.vocab_size for s in streams for t in s)
    # prefill_batch's log-probability of each lane's first token against
    # the no-cache reference's, and every stream fed back through it.
    ref = teacher_forced(ecfg.model, params, prompts, streams)
    first_lp = runner.last_logprobs[0][: len(prompts)].tolist()
    lp_err = max(abs(a - b) for a, b in zip(first_lp, ref.pop("first_token_ref_logprob")))
    gates = {"agreement_min": PHASES_AGREEMENT, "gap_max": NEAR_TIE_NATS,
             "first_logprob_err_max": FIRST_LOGPROB_TOL}
    ok = (ref["logits_finite"] and ref["logits_shape_ok"]
          and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
          and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS
          and lp_err <= FIRST_LOGPROB_TOL)
    result = {
        "phase": phase, "model": ecfg.model.name, "dtype": ecfg.dtype,
        "lanes": len(prompts), "prompt_lens": [len(p) for p in prompts],
        "decode_steps": max_tokens, **times,
        "prefill_kernel_launches": prefill_launches,
        "prefill_tensor_core_launches": prefill_launches_tc,
        "decode_kernel_launches": decode_launches, "num_layers": L,
        "tokens_in_vocab": in_vocab, **ref,
        "first_token_logprob_err_vs_reference": lp_err, "gates": gates,
        "token_match_rate_vs_unified_serve": match_rate(streams, unified_streams),
        "ok": ok,
    }
    emit(result)
    if (prefill_launches != L or prefill_launches_tc != L
            or decode_launches != L * max_tokens):
        fail(f"{phase}: prefill (all, tensor cores) and decode kernel launches",
             [prefill_launches, prefill_launches_tc, decode_launches],
             [L, L, L * max_tokens])
    if not in_vocab:
        fail(f"{phase}: tokens out of the vocabulary", in_vocab, True)
    if not ok:
        fail(f"{phase}: streams disagree with the no-cache reference",
             {"agreement": ref["greedy_agreement_vs_no_cache_reference"],
              "gap": ref["max_logprob_gap_at_disagreement"],
              "first_logprob_err": lp_err}, gates)
    return result


# -- phase: files ------------------------------------------------------------
FILES_ENDPOINT = "dyn://dynamo.files.generate"
FILES_MODEL_NAME = "llama-files"    # --set Run.model-name on the files worker
FILES_MAX_LEN = 1024                # the worker's YAML: Common.max-model-len (CLI: 2048)
FILES_MERGES = 200                  # BPE merges the checkout's tokenizer learns
FILES_SHALLOW = 2                   # the GGUF and DeepSeek checkouts' depth
FILES_CHATS = [
    [{"role": "user", "content": "Write a haiku about serving models from their files."}],
    [{"role": "system", "content": "You are terse."},
     {"role": "user", "content": "What is 2048 + 128256? Über-quick, café-style 🙂"}],
]
FILES_YAML = f"""# the files worker's deployment config (chip_smoke.py phase files)
Common:
  max-model-len: {FILES_MAX_LEN}
Run:
  out: torch
Engine:
  common-configs: [max-model-len]
  num-blocks: 1024
  max-num-seqs: 8
  prefill-batch: 4
  unified-token-budget: 256
  unified-prefill-quantum: 64
"""


async def held_serve(ecfg, params, prompts, max_tokens) -> dict:
    """The prompts through a fresh TorchEngine whose admission is held
    (``warmup_gate="hold"``) while they queue and its warmup runs, so the
    first dispatch composes every prompt, and which retires each dispatch
    before it composes the next (``pipeline_depth=1``: at depth 2 a
    dispatch retires early when the card has finished it, so what the
    next one holds follows timing): two engines with equal weights and
    settings dispatch the same batches. The ragged launches counted over
    the warmup and the serve: one call per layer per warm pass and per
    dispatch."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    engine = TorchEngine(dataclasses.replace(ecfg, warmup_gate="hold", pipeline_depth=1),
                         params=params, device=DEVICE)
    await engine.start()
    try:
        reset_counts()
        task = asyncio.ensure_future(serve(engine, prompts, max_tokens))
        for _ in range(20):
            await asyncio.sleep(0)
        programs = await engine.warmup()
        streams, finishes, _ttft, wall = await task
        warm = engine.runner.compile_stats.capture_snapshot()["graphs_captured"]
        out = {"streams": streams, "wall_s": wall, "warmup_programs": programs,
               "warm_passes": warm, "unified_dispatches": engine.unified_dispatches,
               "kernel_launches": fn.launches,
               "kernel_launches_by_path": {"tc": fn.launches_tc, "split": fn.launches_split,
                                           "walk": fn.launches_walk},
               "mid_traffic_compiles_total": mid_traffic(engine)}
    finally:
        await engine.stop()
    L = ecfg.model.num_layers
    want = L * (out["warm_passes"] + out["unified_dispatches"])
    full = all(len(s) == max_tokens for s in streams)
    if out["kernel_launches"] != want or out["unified_dispatches"] == 0 or not full:
        fail("files: ragged launches (layers x (warm passes + dispatches)) or stream lengths",
             [out["kernel_launches"], full], [want, True])
    return out


async def cli_http_serve(model_path: str, prompt: list[int], max_tokens: int) -> dict:
    """``run --in http --out torch --model-path FILES`` through the CLI's
    own path in this process (the serve's engine settings): one greedy
    completion of token ids, its engine ids tapped, and the ragged
    launches of the engine's warmup and this request."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.pipeline import Tap

    tapped: list[int] = []
    args = cli.build_parser().parse_args([
        *HTTP_ARGS, "--in", "http", "--model-path", model_path,
        "--http-host", "127.0.0.1", "--http-port", "0"])
    cli._apply_config(args)
    cli.refuse_unserved(args)
    reset_counts()
    async with contextlib.AsyncExitStack() as stack:
        service, engine = await cli.start_http(
            args, stack, engine_ops=(Tap(None, lambda ctx, item: tapped.extend(
                item["token_ids"])),))
        name = service.manager.models()[0]
        resp = await fetch("127.0.0.1", service.port, "POST", "/v1/completions", {
            "model": name, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "nvext": {"ignore_eos": True}})
        dispatches = engine.unified_dispatches
        warm = engine.runner.compile_stats.capture_snapshot()["graphs_captured"]
    return {"model": name, "status": resp.status, "tokens": tapped,
            "unified_dispatches": dispatches, "warm_passes": warm,
            "kernel_launches": fn.launches}


def same_params(a, b) -> bool:
    """Two params trees equal key for key and bit for bit, with each
    tensor's dtype and shape (a quantized leaf by its bytes and scales)."""
    if isinstance(a, dict) != isinstance(b, dict) or isinstance(a, list) != isinstance(b, list):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_params(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_params(x, y) for x, y in zip(a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.element_size() == 1:   # int8 / e4m3: compare the bytes
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return bool(torch.equal(a, b))


def timed_load(local, dtype: str, nbytes: int) -> tuple[dict, dict]:
    """(params, the load's bytes, seconds and GB/s): the files read and
    moved to the card, each tensor transposed and cast there."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = local.load_params(dtype, device=DEVICE)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return params, {"bytes": nbytes, "seconds": s, "gb_per_s": nbytes / s / 1e9}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if f.endswith(".safetensors"))


async def files_fleet(src: str, tok, tmp: str) -> dict:
    """A worker process serving the checkout under a --config file and a
    --set, and the CLI's frontend (``--in http --out dyn``) with no model
    files: the worker's directory is gone once it registers, so the
    frontend materializes the tokenizer files the card shipped. Chats,
    streamed and not, through the frontend."""
    import shutil
    import signal

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.pipeline import Tap

    # The worker's own copy of the checkout (hard links), removed later.
    wdir = os.path.join(tmp, "worker_copy")
    os.makedirs(wdir)
    for f in os.listdir(src):
        os.link(os.path.join(src, f), os.path.join(wdir, f))
    yaml_path = os.path.join(tmp, "files.yaml")
    with open(yaml_path, "w") as f:
        f.write(FILES_YAML)
    tapped: dict = {}

    def on_request(ctx):
        tapped[ctx.id] = {"prompt": list(ctx.payload["token_ids"]), "tokens": []}

    def on_response(ctx, item):
        tapped[ctx.id]["tokens"].extend(item["token_ids"])

    children: list = []
    cp = Child("files control plane", ["control-plane", "--host", "127.0.0.1", "--port", "0"])
    children.append(cp)
    obs = None
    try:
        await cp.start()
        addr = (await cp.wait_for(r"control plane on (\S+)", 120))[0].group(1)
        obs = await DistributedRuntime.connect(addr)
        t0 = time.monotonic()
        worker = Child("files worker", [
            "run", "--in", FILES_ENDPOINT, "--out", "torch", "--model-path", wdir,
            "--control-plane", addr, "--config", yaml_path,
            "--set", f"Run.model-name={FILES_MODEL_NAME}"])
        children.append(worker)
        await worker.start()
        await worker.wait_for(r"^worker serving ", FLEET_WAIT_S)
        startup = time.monotonic() - t0
        shutil.rmtree(wdir)
        card = await ModelDeploymentCard.fetch(obs.bus, FILES_MODEL_NAME)
        async with contextlib.AsyncExitStack() as stack:
            args = cli.build_parser().parse_args([
                "run", "--in", "http", "--out", "dyn", "--control-plane", addr,
                "--http-host", "127.0.0.1", "--http-port", "0"])
            cli._apply_config(args)
            cli.refuse_unserved(args)
            service, _ = await cli.start_http(args, stack, engine_ops=(Tap(on_request,
                                                                              on_response),))
            await wait_model(service.port, FILES_MODEL_NAME)
            fe_card = service.manager.card(FILES_MODEL_NAME)
            chats = []
            for messages in FILES_CHATS:
                body = {"model": FILES_MODEL_NAME, "messages": messages, "max_tokens": 32,
                        "temperature": 0, "nvext": {"ignore_eos": True}}
                # A first request of the prompt fills the prefix cache, so
                # the two compared after it reuse the same cached blocks
                # and compute the same rows (a bf16 prefill that reuses a
                # prefix and one that does not may part at a near tie).
                await fetch("127.0.0.1", service.port, "POST", "/v1/chat/completions",
                            {**body, "max_tokens": 1})
                before = set(tapped)
                full = await fetch("127.0.0.1", service.port, "POST",
                                   "/v1/chat/completions", body)
                rid_full = (set(tapped) - before).pop()
                before = set(tapped)
                pieces = []
                streamed = await fetch("127.0.0.1", service.port, "POST",
                                       "/v1/chat/completions", {**body, "stream": True})
                rid_stream = (set(tapped) - before).pop()
                for ev in streamed.events():
                    if ev.data == "[DONE]":
                        continue
                    for choice in json.loads(ev.data).get("choices", []):
                        pieces.append((choice.get("delta") or {}).get("content") or "")
                chats.append((messages, full, "".join(pieces), tapped[rid_full],
                              tapped[rid_stream]))
        worker.signal(signal.SIGTERM)
        report = await worker_exit(worker)
    finally:
        if obs is not None:
            await obs.shutdown()
        for child in children:
            await child.kill()
    checks = []
    for messages, full, joined, tap_full, tap_stream in chats:
        rendered = tok.apply_chat_template(messages)
        want_prompt = tok.encode(rendered)
        body = full.json() if full.status == 200 else {}
        text = body["choices"][0]["message"]["content"] if body else None
        checks.append({
            "status": full.status,
            "prompt_tokens": body.get("usage", {}).get("prompt_tokens"),
            "hf_tokenizer_prompt_tokens": len(want_prompt),
            "prompt_ids_equal_hf_tokenizer": tap_full["prompt"] == want_prompt,
            "completion_tokens": len(tap_full["tokens"]),
            "text_equals_decode_of_ids": text == tok.decode(tap_full["tokens"]),
            "streamed_pieces_join_into_text": joined == text,
            "stream_ids_equal": tap_stream["tokens"] == tap_full["tokens"],
            "text_chars": len(text or ""),
        })
    return {"worker_startup_s": startup, "card_context_length": card and card.context_length,
            "card_artifacts": card and card.extra.get("artifacts"),
            "frontend_model_path": fe_card and fe_card.model_path,
            "chats": checks, "worker": report}


def phase_files(params, prompts, streams, max_tokens, card: str,
                keep_checkout: str | None = None) -> dict:
    """Serving from files (see the module docstring). ``keep_checkout``:
    a directory the llama3.2-1b checkout is written to and left in (the
    wquant phase loads it again), else it lives in the phase's own."""
    import shutil

    from dynamo_tpu_torch.llm.gguf import GgufTokenizer, read_gguf
    from dynamo_tpu_torch.llm.local_model import LocalModel
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.tools import write_checkout as wc

    t_phase = time.monotonic()
    kernels.set_launch_counts({k: 0 for k in kernels.launch_counts()})
    cfg = full_width_config().model
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    out: dict = {"phase": "files", "card": card}
    launches: dict = {}
    try:
        # 1. The full-width llama3.2-1b checkout of the serve's weights.
        src = keep_checkout or os.path.join(tmp, "llama3.2-1b")
        t0 = time.perf_counter()
        nbytes = wc.write_weights(src, cfg, params, shards=2)
        tok_json = wc.llama3_tokenizer(cfg.vocab_size, merges=FILES_MERGES)
        ids = {t["content"]: t["id"] for t in tok_json["added_tokens"]}
        eos = [ids["<|end_of_text|>"], ids["<|eot_id|>"]]
        wc.write_tokenizer(src, tok_json, eos)
        write_s = time.perf_counter() - t0
        local = LocalModel.prepare(src)
        tok = HfTokenizer(src)
        loaded, load = timed_load(local, full_width_config().dtype, dir_bytes(src))
        config_ok = dataclasses.replace(local.config, name=cfg.name) == cfg
        bitwise = same_params(loaded, params)
        ecfg = full_width_config(model=local.config)
        mem = asyncio.run(held_serve(full_width_config(), params, prompts, max_tokens))
        got = asyncio.run(held_serve(ecfg, loaded, prompts, max_tokens))
        del loaded
        free_card()
        alone = asyncio.run(held_serve(full_width_config(), params, prompts[:1], max_tokens))
        http = asyncio.run(cli_http_serve(src, prompts[0], max_tokens))
        free_card()
        launches["checkout"] = got["kernel_launches"]
        launches["checkout_http"] = http["kernel_launches"]
        out["checkout"] = {
            "shards": sorted(f for f in os.listdir(src) if f.endswith(".safetensors")),
            "write_s": write_s, "load": load, "config_equal": config_ok,
            "params_bitwise_equal": bitwise, "tokenizer_vocab": tok.vocab_size,
            "eos_token_ids": tok.eos_token_ids,
            "streams_identical_to_params_engine": got["streams"] == mem["streams"],
            "match_rate_vs_serve_phase": match_rate(got["streams"], streams),
            "cli_http": {k: http[k] for k in ("model", "status", "unified_dispatches",
                                              "kernel_launches")},
            "cli_http_stream_equals_params_engine": http["tokens"] == alone["streams"][0],
            **{k: got[k] for k in ("wall_s", "warm_passes", "unified_dispatches",
                                   "kernel_launches", "kernel_launches_by_path")},
        }
        emit({"phase": "files_checkout", **out["checkout"]})
        http_ok = (http["status"] == 200 and http["tokens"] == alone["streams"][0]
                   and http["kernel_launches"] == cfg.num_layers * (
                       http["warm_passes"] + http["unified_dispatches"]))
        if not (config_ok and bitwise and got["streams"] == mem["streams"]
                and tok.eos_token_ids == eos and http_ok):
            fail("files: the checkout's config, weights or streams differ from the serve's",
                 [config_ok, bitwise, got["streams"] == mem["streams"], tok.eos_token_ids,
                  http_ok], [True, True, True, eos, True])

        # 2. The process fleet: a worker under --config/--set, a frontend
        # without the model's files.
        fleet = asyncio.run(files_fleet(src, tok, tmp))
        launches["fleet_worker"] = fleet["worker"]["kernel_launches"][
            "ragged_paged_attention_cuda.launches"]
        out["fleet"] = fleet
        emit({"phase": "files_fleet", **fleet})
        chats_ok = all(c["status"] == 200 and c["prompt_tokens"] == c[
            "hf_tokenizer_prompt_tokens"] and c["prompt_ids_equal_hf_tokenizer"]
            and c["completion_tokens"] == 32 and c["text_equals_decode_of_ids"]
            and c["streamed_pieces_join_into_text"] and c["stream_ids_equal"]
            and c["text_chars"] > 0 for c in fleet["chats"])
        materialized = bool(fleet["frontend_model_path"]) and fleet[
            "frontend_model_path"].startswith(tempfile.gettempdir())
        if not (chats_ok and fleet["card_context_length"] == FILES_MAX_LEN and materialized
                and launches_ok(fleet["worker"], walk_path=False)):
            fail("files: the fleet's chats, its config values or its launches",
                 {"chats": fleet["chats"], "context_length": fleet["card_context_length"],
                  "frontend_model_path": fleet["frontend_model_path"]},
                 {"context_length": FILES_MAX_LEN})
        if keep_checkout is None:
            shutil.rmtree(src)

        # 3. A GGUF (F16, FILES_SHALLOW layers, the whole vocabulary) and a
        # safetensors checkout of the same F16 weights.
        shallow = cfg.scaled(num_layers=FILES_SHALLOW)
        sp = {"embed": params["embed"], "ln_f": params["ln_f"],
              "layers": params["layers"][:FILES_SHALLOW]}
        gguf_path = os.path.join(tmp, "llama3.2-1b-f16.gguf")
        st_dir = os.path.join(tmp, "llama3.2-1b-f16")
        t0 = time.perf_counter()
        gguf_bytes = wc.write_gguf_checkout(gguf_path, shallow, sp, tok_json, eos[1],
                                            dtype=torch.float16)
        st_bytes = wc.write_weights(st_dir, shallow, sp, dtype=torch.float16)
        write_s = time.perf_counter() - t0
        g_local, s_local = LocalModel.prepare(gguf_path), LocalModel.prepare(st_dir)
        from_gguf, g_load = timed_load(g_local, full_width_config().dtype, gguf_bytes)
        from_st, s_load = timed_load(s_local, full_width_config().dtype, st_bytes)
        bitwise = same_params(from_gguf, from_st)
        gtok = GgufTokenizer(read_gguf(gguf_path, load_tensors_index=False))
        text = FILES_CHATS[1][1]["content"]
        g_cfg_ok = dataclasses.replace(g_local.config, name=shallow.name) == shallow
        g = asyncio.run(held_serve(full_width_config(model=g_local.config), from_gguf,
                                   prompts, max_tokens))
        s = asyncio.run(held_serve(full_width_config(model=s_local.config), from_st,
                                   prompts, max_tokens))
        alone = asyncio.run(held_serve(full_width_config(model=s_local.config), from_st,
                                       prompts[:1], max_tokens))
        del from_gguf, from_st
        free_card()
        http = asyncio.run(cli_http_serve(gguf_path, prompts[0], max_tokens))
        free_card()
        launches["gguf"] = g["kernel_launches"]
        launches["gguf_http"] = http["kernel_launches"]
        out["gguf"] = {
            "layers": FILES_SHALLOW, "write_s": write_s, "gguf_load": g_load,
            "safetensors_f16_load": s_load, "config_equal": g_cfg_ok,
            "params_bitwise_equal_to_safetensors": bitwise,
            "embedded_vocab": gtok.vocab_size,
            "embedded_tokenizer_round_trip": gtok.decode(gtok.encode(text)) == text,
            "streams_identical_to_safetensors": g["streams"] == s["streams"],
            "cli_http": {k: http[k] for k in ("model", "status", "unified_dispatches",
                                              "kernel_launches")},
            "cli_http_stream_equals_safetensors": http["tokens"] == alone["streams"][0],
            **{k: g[k] for k in ("wall_s", "unified_dispatches", "kernel_launches",
                                 "kernel_launches_by_path")},
        }
        emit({"phase": "files_gguf", **out["gguf"]})
        http_ok = (http["status"] == 200 and http["tokens"] == alone["streams"][0]
                   and http["kernel_launches"] == FILES_SHALLOW * (
                       http["warm_passes"] + http["unified_dispatches"]))
        if not (g_cfg_ok and bitwise and g["streams"] == s["streams"]
                and out["gguf"]["embedded_tokenizer_round_trip"] and http_ok):
            fail("files: the GGUF's config, weights, tokenizer or streams",
                 [g_cfg_ok, bitwise, g["streams"] == s["streams"], http_ok],
                 [True, True, True, True])
        os.remove(gguf_path)
        shutil.rmtree(st_dir)

        # 4. DeepSeek-V2-Lite at full width, FILES_SHALLOW layers (the
        # dense first layer and one MoE layer), through the 576-wide
        # ragged entry: float32 and bf16 checkouts against the same
        # weights given as a parameter tree.
        lite = ModelConfig.deepseek_v2_lite().scaled(num_layers=FILES_SHALLOW)
        rng = np.random.default_rng(15)
        mla_prompts = [rng.integers(0, lite.vocab_size, n).tolist()
                       for n in rng.integers(*MLA_LENS, 8)]
        out["deepseek"] = {}
        for dtype in ("float32", "bfloat16"):
            tree = seeded_params(lite, 3, getattr(torch, dtype))
            ds_dir = os.path.join(tmp, f"deepseek-v2-lite-{dtype}")
            t0 = time.perf_counter()
            nb = wc.write_weights(ds_dir, lite, tree, shards=2)
            write_s = time.perf_counter() - t0
            ds_local = LocalModel.prepare(ds_dir)
            ds_loaded, ds_load = timed_load(ds_local, dtype, nb)
            ok_cfg = dataclasses.replace(ds_local.config, name=lite.name) == lite
            bitwise = same_params(ds_loaded, tree)
            dcfg = family_config(ds_local.config, dtype=dtype)
            a = asyncio.run(held_serve(dcfg, tree, mla_prompts, max_tokens))
            b = asyncio.run(held_serve(dcfg, ds_loaded, mla_prompts, max_tokens))
            ref = teacher_forced(ds_local.config, ds_loaded, mla_prompts, b["streams"])
            ref.pop("first_token_ref_logprob")
            del tree, ds_loaded
            free_card()
            shutil.rmtree(ds_dir)
            key = "f32" if dtype == "float32" else "bf16"
            launches[f"deepseek_{key}"] = b["kernel_launches"]
            identical = a["streams"] == b["streams"]
            limit = MLA_BF16_LIMITS["mla_bf16_dense"]
            leg = {"write_s": write_s, "load": ds_load, "config_equal": ok_cfg,
                   "params_bitwise_equal": bitwise,
                   "streams_identical_to_params_engine": identical,
                   "match_rate_vs_params_engine": match_rate(a["streams"], b["streams"]),
                   **ref, **{k: b[k] for k in ("wall_s", "unified_dispatches",
                                               "kernel_launches", "kernel_launches_by_path")}}
            out["deepseek"][key] = leg
            emit({"phase": "files_deepseek", "dtype": dtype, **leg})
            held = identical if dtype == "float32" else (
                identical or (ref["greedy_agreement_vs_no_cache_reference"] >= limit[0]
                              and ref["max_logprob_gap_at_disagreement"] <= limit[1]))
            if not (ok_cfg and bitwise and held and ref["logits_finite"]):
                fail(f"files: the DeepSeek {dtype} checkout's config, weights or streams",
                     [ok_cfg, bitwise, identical, ref["greedy_agreement_vs_no_cache_reference"]],
                     [True, True, True, limit])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["ragged_launches"] = launches
    out["phase_s"] = time.monotonic() - t_phase
    emit({"phase": "files", "card": card, "ragged_launches": launches,
          "phase_s": out["phase_s"]})
    return out


# -- phase wquant -------------------------------------------------------------
WQ_POLICIES = [("int8", None), ("fp8", None), ("attn=int8,mlp=fp8", None), ("int8", "int8")]
WQ_TOKENS = (1, 16, 64, 256)      # kernel cases' activation rows
WQ_RAGGED_TOKENS = (17, 65, 200)  # rows off the token tiles (llama3.2-1b q, tied head)
WQ_8B_LENS = (64, 513)            # llama3-8b prompts: 4 of this many tokens ...
WQ_8B_TOKENS = 32                 # ... for this many greedy tokens each
# llama3-8b's 32 bf16 layers of random weights put near ties just past
# phase 8's 0.02 nats (the bf16 leg read 0.0179 and 0.0234 in two runs on
# the H100, agreement 0.977 both; the arrivals race, so the batches and
# their roundings differ run to run): both 8B legs are held to this
# (agreement at least, largest gap at most). A wrong model reads near 0
# and several nats.
WQ_8B_LIMITS = (0.9, 0.05)
WQ_MLA_TOKENS = 16                # deepseek-v2-lite's 2-layer legs, 4 prompts each
WQ_BUDGET_S = 300.0               # the phase's wall time, at most
WQ_MAIN_CASE = "llama3.2-1b_tied_head_int8_T16"


def reset_wq() -> None:
    """The weight-quantized GEMM's launch counters and the plain arm's
    calls to 0."""
    from dynamo_tpu_torch.ops.kernels.wq_gemm import wq_gemm_cuda
    from dynamo_tpu_torch.ops.quant import PLAIN_CALLS

    for entry in ("", "_decode", "_rows", "_f32"):
        setattr(wq_gemm_cuda, f"launches{entry}", 0)
    PLAIN_CALLS["count"] = 0


def wq_counts() -> dict:
    from dynamo_tpu_torch.ops.kernels.wq_gemm import wq_gemm_cuda
    from dynamo_tpu_torch.ops.quant import PLAIN_CALLS

    return {"launches": wq_gemm_cuda.launches, "launches_decode": wq_gemm_cuda.launches_decode,
            "launches_rows": wq_gemm_cuda.launches_rows,
            "launches_f32": wq_gemm_cuda.launches_f32, "plain_calls": PLAIN_CALLS["count"]}


def wq_weight(B, N, K, fmt, act, transposed, cache: dict) -> tuple:
    """A random bf16 weight quantized on the card (in float32 for float32
    activations) and its dequantized bf16 copy for the library call,
    made once per shape and format."""
    from dynamo_tpu_torch.ops import quant as tq

    key = (B, N, K, fmt, act, transposed)
    if key not in cache:
        cache.clear()
        g = torch.Generator(device=DEVICE)
        g.manual_seed(B * 7919 + N + K)
        shape = (B, N, K) if transposed else (B, K, N)
        w = (torch.randn(shape, generator=g, device=DEVICE) / K ** 0.5).to(torch.bfloat16)
        axis = -1 if transposed else -2
        qw = tq.quantize_weight(w if act == torch.bfloat16 else w.float(), axis=axis, fmt=fmt)
        del w
        deq = tq.dequantize_weight(qw, torch.bfloat16, axis=axis)
        cache[key] = (qw, deq.transpose(-1, -2) if transposed else deq)
    return cache[key]


def wq_case(name, B, M, N, K, fmt, act, cache, transposed=False, out_dtype=None,
            strided=False) -> dict:
    """One product through the kernel against its plain version on the
    same inputs (activations from a seed), timed beside the plain
    version, the bound and one cuBLAS bf16 product on the unquantized
    weight (the cost quantization should beat; the port never calls
    it)."""
    from dynamo_tpu_torch.ops.kernels import wq_gemm as wk

    qw, wlib = wq_weight(B, N, K, fmt, act, transposed, cache)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(M)
    if strided:
        # MLA's per-head operand: [T, H, width] rows, the head the batch.
        a = torch.randn((M, B, K + 64), generator=g, device=DEVICE).to(act)[..., :K]
        a = a.permute(1, 0, 2)
    else:
        a = torch.randn((B, M, K), generator=g, device=DEVICE).to(act)
    out_dtype = out_dtype or act
    kernel = lambda: wk.wq_gemm_cuda(a, qw["q"], qw["s"], out_dtype=out_dtype,  # noqa: E731
                                     transposed=transposed)
    plain = lambda: wk.wq_gemm_plain(a, qw["q"], qw["s"], out_dtype, transposed)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    abs_err = max_err(got, want)
    rel_err = abs_err / max(want.float().abs().max().item(), 1e-12)
    check("wquant", name, {"max_rel_err": rel_err}, KERNEL_TOL[act], max_abs_err=abs_err)
    alib = a.to(torch.bfloat16)
    kw = {} if out_dtype == torch.bfloat16 else {"out_dtype": out_dtype}
    if B == 1:
        library = lambda: torch.mm(alib[0], wlib[0], **kw)  # noqa: E731
    else:
        library = lambda: torch.bmm(alib, wlib, **kw)  # noqa: E731
    nbytes = (qw["q"].numel() + qw["s"].numel() * qw["s"].element_size()
              + B * M * K * a.element_size() + B * M * N * got.element_size())
    bound_ms, bound_by = bound(nbytes, 2 * B * M * N * K, act)
    kernel_ms, library_ms = device_ms(kernel, iters=10), device_ms(library, iters=5)
    return {"max_abs_err": abs_err, "max_rel_err": rel_err, "kernel_ms": kernel_ms,
            "plain_ms": device_ms(plain, iters=1), "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "kernel_over_library": kernel_ms / library_ms, "bound_share": bound_ms / kernel_ms,
            "plan": list(wk.kernel_plan(B, M, N, K, torch.cuda.get_device_properties(
                0).multi_processor_count, act == torch.bfloat16))}


def wq_kernel_cases() -> dict:
    """The kernel at the main paths' shapes (each against its plain
    version, timed): llama3.2-1b's and llama3-8b's projections, MLP, tied
    and untied heads at T in WQ_TOKENS, int8 and e4m3, bf16 activations;
    llama3.2-1b's q and tied head at WQ_RAGGED_TOKENS (rows off the token
    tiles); deepseek-v2-lite's stacked experts (dense decode and capacity
    buffers), the split_bmm hi/lo rows and MLA's per-head w_uk / w_uv;
    float32 activations at one shape of each entry."""
    f32 = torch.float32
    bf = torch.bfloat16
    shapes = {   # name: (N, K, transposed, f32 out)
        "llama3.2-1b_q": (2048, 2048, False, False), "llama3.2-1b_kv": (512, 2048, False, False),
        "llama3.2-1b_o": (2048, 2048, False, False), "llama3.2-1b_gate_up": (8192, 2048, False, False),
        "llama3.2-1b_down": (2048, 8192, False, False),
        "llama3.2-1b_tied_head": (128256, 2048, True, True),
        "llama3-8b_q": (4096, 4096, False, False), "llama3-8b_kv": (1024, 4096, False, False),
        "llama3-8b_o": (4096, 4096, False, False), "llama3-8b_gate_up": (14336, 4096, False, False),
        "llama3-8b_down": (4096, 14336, False, False), "llama3-8b_head": (128256, 4096, False, True),
    }
    cases, cache = {}, {}
    for fmt in ("int8", "fp8"):
        for name, (N, K, tr, f32_out) in shapes.items():
            for T in WQ_TOKENS:
                cases[f"{name}_{fmt}_T{T}"] = wq_case(
                    f"{name}_{fmt}_T{T}", 1, T, N, K, fmt, bf, cache, transposed=tr,
                    out_dtype=f32 if f32_out else None)
        for name in ("llama3.2-1b_q", "llama3.2-1b_tied_head"):
            N, K, tr, f32_out = shapes[name]
            for T in WQ_RAGGED_TOKENS:
                cases[f"{name}_{fmt}_T{T}"] = wq_case(
                    f"{name}_{fmt}_T{T}", 1, T, N, K, fmt, bf, cache, transposed=tr,
                    out_dtype=f32 if f32_out else None)
        # deepseek-v2-lite: 64 experts' w_gate/w_up (dense decode: 4 rows
        # each; capacity at the 256 rung: C = 48), w_down's split_bmm rows
        # (2C), MLA's per-head einsums at (H, dn|v, dc) = (16, 128, 512).
        for C in (4, 48):
            cases[f"deepseek_experts_up_{fmt}_C{C}"] = wq_case(
                f"deepseek_experts_up_{fmt}_C{C}", 64, C, 1408, 2048, fmt, bf, cache, out_dtype=f32)
        cases[f"deepseek_experts_down_hilo_{fmt}"] = wq_case(
            f"deepseek_experts_down_hilo_{fmt}", 64, 96, 2048, 1408, fmt, bf, cache, out_dtype=f32)
        for T in (16, 256):
            cases[f"mla_w_uk_{fmt}_T{T}"] = wq_case(f"mla_w_uk_{fmt}_T{T}", 16, T, 512, 128,
                                                   fmt, bf, cache, strided=True)
            cases[f"mla_w_uv_{fmt}_T{T}"] = wq_case(f"mla_w_uv_{fmt}_T{T}", 16, T, 128, 512,
                                                   fmt, bf, cache, transposed=True, strided=True)
        # float32 activations (the SIMT loop): one shape each.
        cases[f"f32_q_{fmt}"] = wq_case(f"f32_q_{fmt}", 1, 16, 2048, 2048, fmt, f32, cache)
        cases[f"f32_tied_head_{fmt}"] = wq_case(f"f32_tied_head_{fmt}", 1, 16, 128256, 2048,
                                                fmt, f32, cache, transposed=True)
        cases[f"f32_experts_{fmt}"] = wq_case(f"f32_experts_{fmt}", 64, 8, 1408, 2048, fmt, f32, cache)
    cache.clear()
    return cases


# (name, B, M, N, K, transposed): a decode product whose K splits (the
# last split to arrive sums the partials) and a rows product that splits.
WQ_DETERMINISM = [("llama3.2-1b_q_int8_T1", 1, 1, 2048, 2048, False),
                  ("llama3.2-1b_q_int8_T256", 1, 256, 2048, 2048, False),
                  ("llama3.2-1b_tied_head_int8_T200", 1, 200, 128256, 2048, True)]


def wq_determinism() -> dict:
    """Two launches on the same inputs give the same bytes (the split
    sums run in split order, whichever split arrives last)."""
    from dynamo_tpu_torch.ops.kernels import wq_gemm as wk

    out, cache = {}, {}
    for name, B, M, N, K, tr in WQ_DETERMINISM:
        qw, _ = wq_weight(B, N, K, "int8", torch.bfloat16, tr, cache)
        g = torch.Generator(device=DEVICE)
        g.manual_seed(M)
        a = torch.randn((B, M, K), generator=g, device=DEVICE).to(torch.bfloat16)
        od = torch.float32 if tr else torch.bfloat16
        runs = [wk.wq_gemm_cuda(a, qw["q"], qw["s"], out_dtype=od, transposed=tr)
                for _ in range(2)]
        torch.cuda.synchronize()
        plan = wk.kernel_plan(B, M, N, K, torch.cuda.get_device_properties(
            0).multi_processor_count)
        out[name] = {"equal_bytes": bool(torch.equal(runs[0].view(torch.uint8),
                                                      runs[1].view(torch.uint8))),
                     "plan": list(plan)}
    cache.clear()
    emit({"phase": "wquant_determinism", "cases": out})
    if not all(v["equal_bytes"] for v in out.values()):
        fail("wquant: two launches on the same inputs differ", out, "equal bytes")
    if not any(v["plan"][2] > 1 for v in out.values()):
        fail("wquant: no determinism case splits K", out, "a split")
    return out


async def wquant_http(extra: list[str]) -> dict:
    """``run --in http --out torch --model-path preset:llama3.2-1b
    <extra>`` through the CLI's own path in this process: one chat
    completion, then /metrics; the wq_gemm launches of the warmup and
    the request."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch

    args = cli.build_parser().parse_args([
        *HTTP_ARGS, "--in", "http", "--http-host", "127.0.0.1", "--http-port", "0", *extra])
    cli._apply_config(args)
    cli.refuse_unserved(args)
    reset_wq()
    async with contextlib.AsyncExitStack() as stack:
        service, engine = await cli.start_http(args, stack)
        name = service.manager.models()[0]
        resp = await fetch("127.0.0.1", service.port, "POST", "/v1/chat/completions", {
            "model": name, "messages": [{"role": "user", "content": "hello, card"}],
            "max_tokens": 16, "temperature": 0})
        body = resp.json()
        metrics = (await fetch("127.0.0.1", service.port, "GET", "/metrics")).body.decode()
        dispatches = engine.unified_dispatches
    gauges = {k: metric_value(metrics, k) for k in (
        "weight_quant_active", "weight_quant_bytes_saved", "weight_quant_density")}
    return {"status": resp.status, "completion_tokens": body["usage"]["completion_tokens"],
            "gauges": gauges, "unified_dispatches": dispatches, "wq_gemm": wq_counts()}


def wq_serve_gates(leg: str, served: dict, bf16_graphs: int | None, f32: bool = False,
                   rows: bool = False) -> None:
    """A quantized serve went through the kernel (bf16: the wgmma kernel,
    with `rows` its rows entry among them; float32: the SIMT loop), never
    the plain arm, captured as many graphs as the unquantized engine
    (where one was served) and nothing mid-traffic (serve_family's gate),
    with the policy's gauges set."""
    wq, gauges = served["wq_gemm"], served["weight_quant"]
    entry, other = ("launches_f32", "launches") if f32 else ("launches", "launches_f32")
    if not (wq[entry] > 0 and wq[other] == 0 and wq["plain_calls"] == 0
            and wq["launches"] == wq["launches_decode"] + wq["launches_rows"]
            and (wq["launches_rows"] > 0 or not rows)):
        fail(f"{leg}: wq_gemm launches (kernel > 0, other entry and plain arm 0)", wq,
             {entry: "> 0", other: 0, "plain_calls": 0,
              "launches_rows": "> 0" if rows else ">= 0"})
    if bf16_graphs is not None and served["capture"]["graphs_captured"] != bf16_graphs:
        fail(f"{leg}: graphs captured against the unquantized engine's",
             served["capture"]["graphs_captured"], bf16_graphs)
    if not (gauges.get("weight_quant_bytes_saved", 0) > 0
            and 0.0 < gauges.get("weight_quant_density", 0) <= 1.0):
        fail(f"{leg}: weight-quant gauges", gauges, {"bytes_saved": "> 0"})


def phase_wquant(card: str, prompts, more, streams, served: dict, checkout: str) -> dict:
    """Weight quantization on the card (see the module docstring)."""
    from dynamo_tpu_torch.llm.local_model import LocalModel
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import kernels

    t_phase = time.monotonic()
    kernels.set_launch_counts({k: 0 for k in kernels.launch_counts()})
    free_card()
    out: dict = {"phase": "wquant", "card": card, "legs": {}}
    stage_s = {}
    cases = wq_kernel_cases()
    main = cases[WQ_MAIN_CASE]
    bf16_cases = [c for n, c in cases.items() if not n.startswith("f32_")]
    out["kernel"] = {**main, "max_abs_err": max(c["max_abs_err"] for c in bf16_cases),
                     "max_rel_err": max(c["max_rel_err"] for c in bf16_cases),
                     "max_rel_err_f32": max(c["max_rel_err"] for n, c in cases.items()
                                            if n.startswith("f32_"))}
    out["cases"] = cases
    emit({"phase": "wquant_kernel_table", "card": card, "cases": cases})
    out["determinism"] = wq_determinism()
    stage_s["kernel_cases"] = time.monotonic() - t_phase
    free_card()

    # llama3.2-1b at full width under each policy, its weights the serve
    # phase's draws quantized as they are drawn.
    cfg = full_width_config().model
    bf16_graphs = served["capture"]["graphs_captured"]
    for spec, kvq in WQ_POLICIES:
        t0 = time.monotonic()
        leg = f"llama3.2-1b_{spec}" + (f"_kv_{kvq}" if kvq else "")
        params = seeded_params(cfg, 0, torch.bfloat16, spec)
        res, got = asyncio.run(serve_family(
            full_width_config(weight_quant=spec, kv_quant=kvq), params, prompts, 32,
            f"wquant_{leg}", profile_prompts=more))
        wq_serve_gates(leg, res, bf16_graphs, rows=spec == "int8" and kvq is None)
        res["greedy_match_vs_bf16_same_weights"] = match_rate(got, streams)
        res["leg_s"] = time.monotonic() - t0
        out["legs"][leg] = res
        emit({"phase": "wquant_leg", "leg": leg, "card": card,
              **{k: res[k] for k in ("tokens_per_s", "ttft_p50_ms", "device_ms_per_dispatch",
                                     "device_busy_share", "weight_bytes", "weight_quant",
                                     "wq_gemm", "kernel_launches", "unified_dispatches",
                                     "greedy_match_vs_bf16_same_weights", "leg_s")},
              "graphs_captured": res["capture"]["graphs_captured"]})
        if spec == "int8" and kvq is None:
            int8_params = params
        else:
            del params
        free_card()
    stage_s["llama3.2-1b"] = time.monotonic() - t_phase - sum(stage_s.values())

    # The OpenAI server through the CLI's own path, quantizing as it draws.
    http = asyncio.run(wquant_http(["--weight-quant", "int8"]))
    out["http"] = http
    emit({"phase": "wquant_http", **http})
    g = http["gauges"]
    if not (http["status"] == 200 and http["completion_tokens"] > 0
            and g["weight_quant_active"] == 1.0 and (g["weight_quant_bytes_saved"] or 0) > 0
            and 0.9 < (g["weight_quant_density"] or 0) <= 1.0
            and http["wq_gemm"]["launches"] > 0 and http["wq_gemm"]["plain_calls"] == 0):
        fail("wquant: the int8 server's reply, gauges or launches", http,
             {"status": 200, "weight_quant_active": 1.0, "density": "(0.9, 1]"})
    free_card()

    # The files phase's bf16 checkout (the serve's weights), quantized as
    # it loads: equal to the draws quantized as drawn; the load's peak.
    policy = llama.WeightQuantPolicy.from_string("int8")
    local = LocalModel.prepare(checkout)
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loaded = local.load_params("bfloat16", DEVICE, policy)
    torch.cuda.synchronize()
    load = {"seconds": time.perf_counter() - t0,
            "peak_bytes_over_start": torch.cuda.max_memory_allocated() - base,
            "resident_bytes": param_bytes(loaded), "bf16_bytes": cfg.param_count() * 2,
            "equal_to_drawn_int8": same_params(loaded, int8_params)}
    out["checkout_load"] = load
    emit({"phase": "wquant_checkout_load", **load})
    if not load["equal_to_drawn_int8"]:
        fail("wquant: the checkout quantized on load differs from the drawn int8 tree",
             False, True)
    del loaded, int8_params
    free_card()

    # llama3-8b at full width, bf16 then int8: is the dispatch's weight
    # stream halved?
    t0 = time.monotonic()
    cfg8 = ModelConfig.llama3_8b()
    rng = np.random.default_rng(8)
    p8 = [rng.integers(0, cfg8.vocab_size, n).tolist() for n in rng.integers(*WQ_8B_LENS, 4)]
    m8 = [rng.integers(0, cfg8.vocab_size, n).tolist() for n in rng.integers(*WQ_8B_LENS, 4)]
    out["llama3-8b"] = {}
    graphs8 = None
    for spec in (None, "int8"):
        name = spec or "bf16"
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = seeded_params(cfg8, 0, torch.bfloat16, spec)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() - base
        res, _ = asyncio.run(serve_family(
            family_config(cfg8, weight_quant=spec), params, p8, WQ_8B_TOKENS,
            f"wquant_llama3-8b_{name}", profile_prompts=m8, limits=WQ_8B_LIMITS))
        if spec:
            wq_serve_gates(f"llama3-8b_{name}", res, graphs8, rows=True)
        elif res["wq_gemm"]["launches"]:
            fail("wquant: the bf16 llama3-8b serve launched wq_gemm", res["wq_gemm"], 0)
        graphs8 = res["capture"]["graphs_captured"]
        leg = {k: res[k] for k in ("tokens_per_s", "ttft_p50_ms", "device_ms_per_dispatch",
                                   "device_busy_share", "top_kernels_ms", "weight_bytes",
                                   "weight_quant", "wq_gemm", "unified_dispatches",
                                   "greedy_agreement_vs_no_cache_reference",
                                   "max_logprob_gap_at_disagreement")}
        leg["init_peak_bytes_over_start"] = init_peak
        leg["weight_pass_bound_ms"] = res["weight_bytes"] / HBM_BYTES_PER_S * 1e3
        leg["graphs_captured"] = res["capture"]["graphs_captured"]
        out["llama3-8b"][name] = leg
        emit({"phase": "wquant_llama3-8b", "leg": name, "card": card, **leg})
        del params
        free_card()
    stage_s["llama3-8b"] = time.monotonic() - t0

    # deepseek-v2-lite at full width, 2 layers (dense, then MoE), int8:
    # MLA's ladder, the 64 stacked experts and the shared experts through
    # the kernel; a float32 witness (the SIMT entry) and a bf16 leg, both
    # drop-free under phase 8's gates.
    t0 = time.monotonic()
    lite = ModelConfig.deepseek_v2_lite().scaled(num_layers=FILES_SHALLOW,
                                                 moe_dispatch="dense")
    rng = np.random.default_rng(15)
    lp = [rng.integers(0, lite.vocab_size, n).tolist() for n in rng.integers(*MLA_LENS, 4)]
    out["deepseek"] = {}
    for dtype in ("float32", "bfloat16"):
        params = seeded_params(lite, 1, getattr(torch, dtype), "int8")
        res, _ = asyncio.run(serve_family(
            family_config(lite, dtype=dtype, weight_quant="int8"), params, lp, WQ_MLA_TOKENS,
            f"wquant_deepseek_{dtype}"))
        wq_serve_gates(f"deepseek_{dtype}", res, None, f32=dtype == "float32")
        out["deepseek"][dtype] = {k: res[k] for k in (
            "tokens_per_s", "ttft_p50_ms", "weight_bytes", "weight_quant", "wq_gemm",
            "kernel_launches", "unified_dispatches", "greedy_agreement_vs_no_cache_reference",
            "max_logprob_gap_at_disagreement")}
        emit({"phase": "wquant_deepseek", "dtype": dtype, **out["deepseek"][dtype]})
        del params
        free_card()
    stage_s["deepseek"] = time.monotonic() - t0

    out["stage_s"] = stage_s
    out["phase_s"] = time.monotonic() - t_phase
    emit({"phase": "wquant", "card": card, "stage_s": stage_s, "phase_s": out["phase_s"],
          "kernel": out["kernel"]})
    if out["phase_s"] > WQ_BUDGET_S:
        fail("wquant: wall seconds", out["phase_s"], WQ_BUDGET_S)
    return out


FLEET_ENDPOINT = "dyn://dynamo.torch.generate"
FLEET_WAIT_S = 240.0          # a worker's spawn → "worker serving" bound


class Child:
    """One subprocess of the fleet phase (``python -m dynamo_tpu_torch
    ...``): stdout and stderr merged, read line by line as they come,
    each line kept with its arrival time."""

    def __init__(self, name: str, argv: list[str], module: str = "dynamo_tpu_torch",
                 env: dict | None = None) -> None:
        self.name = name
        self.argv = argv
        self.module = module
        self.env = env
        self.proc = None
        self.lines: list[tuple[float, str]] = []
        self.t_spawn = 0.0
        self._more = asyncio.Event()
        self._reader = None

    async def start(self) -> "Child":
        self.t_spawn = time.monotonic()
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", self.module, *self.argv,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=None if self.env is None else {**os.environ, **self.env},
        )
        self._reader = asyncio.ensure_future(self._read())
        return self

    async def _read(self) -> None:
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                break
            self.lines.append((time.monotonic(), line.decode(errors="replace")))
            self._more.set()
        self._more.set()

    def tail(self, n: int = 30) -> str:
        return "".join(text for _, text in self.lines[-n:])

    async def wait_for(self, pattern: str, timeout: float):
        """(match, arrival time) of the first line matching ``pattern``;
        fails the phase if the process ends or the time runs out first."""
        import re

        pat = re.compile(pattern)
        deadline = time.monotonic() + timeout
        seen = 0
        while True:
            for t, text in self.lines[seen:]:
                m = pat.search(text)
                if m:
                    return m, t
            seen = len(self.lines)
            if self._reader.done():
                fail(f"fleet: {self.name} ended (rc {self.proc.returncode}) "
                                 f"before {pattern!r}:\n{self.tail()}")
            left = deadline - time.monotonic()
            if left <= 0:
                fail(f"fleet: {self.name} gave no {pattern!r} in "
                                 f"{timeout:.0f} s:\n{self.tail()}")
            self._more.clear()
            try:
                await asyncio.wait_for(self._more.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def exit_code(self, timeout: float) -> int:
        try:
            await asyncio.wait_for(self.proc.wait(), timeout)
        except asyncio.TimeoutError:
            raise GateFailed(f"fleet: {self.name} did not exit in {timeout:.0f} s:\n"
                             f"{self.tail()}") from None
        await self._reader
        return self.proc.returncode

    def signal(self, sig) -> None:
        if self.proc.returncode is None:
            self.proc.send_signal(sig)

    async def kill(self) -> None:
        """SIGKILL the process and every process below it: a planner's
        workers run in sessions of their own and would outlive it."""
        if self.proc is not None and self.proc.returncode is None:
            below = descendants(self.proc.pid)
            self.proc.kill()
            kill_pids(below)
            await self.proc.wait()
        if self._reader is not None:
            await self._reader


def descendants(pid: int) -> list[int]:
    """Every live (not zombie) process below ``pid``, read from /proc."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            found.append(child)
            todo.append(child)
    return found


def kill_pids(pids) -> None:
    import signal

    for pid in pids:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)


def become_subreaper() -> None:
    """Processes orphaned below this one (a killed planner's workers) are
    re-parented to it rather than to init, so ``stop_leftovers`` finds
    them. Linux's PR_SET_CHILD_SUBREAPER, on this process only."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


def stop_leftovers(timeout: float = 10.0) -> list[str]:
    """SIGKILL every process still below this one and wait until none is
    left; the command lines of those it found."""
    left = descendants(os.getpid())
    names = []
    for pid in left:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                names.append(f"{pid}: " + f.read().replace(b"\0", b" ").decode(errors="replace"))
        except OSError:
            names.append(str(pid))
    kill_pids(left)
    deadline = time.monotonic() + timeout
    while left and time.monotonic() < deadline:
        with contextlib.suppress(ChildProcessError):
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        time.sleep(0.05)
        left = descendants(os.getpid())
        kill_pids(left)
    return names


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def spawn_workers(addr: str, n: int, dtype: str, tag: str) -> list:
    """n workers serving FLEET_ENDPOINT with the serve's engine settings,
    each with a health port; waits until each is warmed up and serving.
    Returns [(Child, lease id, health port, startup seconds)]."""
    workers = []
    for i in range(n):
        port = free_port()
        argv = [*HTTP_ARGS, "--in", FLEET_ENDPOINT, "--control-plane", addr,
                "--health-port", str(port), "--dtype", dtype]
        workers.append((await Child(f"worker {tag}{i}", argv).start(), port))
    out = []
    for child, port in workers:
        lease = int((await child.wait_for(r"\(lease (0x[0-9a-f]+)\)", FLEET_WAIT_S))[0]
                    .group(1), 16)
        _, t_serving = await child.wait_for(r"worker serving ", FLEET_WAIT_S)
        out.append((child, lease, port, t_serving - child.t_spawn))
    return out


async def instance_leases(drt) -> set[int]:
    keys = await drt.store.get_prefix("instances/dynamo/torch/generate:")
    return {int(k.rsplit(":", 1)[1], 16) for k in keys}


async def wait_leases(drt, want: set[int], timeout: float = 30.0) -> float:
    """Seconds until the discovery store holds exactly ``want``."""
    t0 = time.monotonic()
    while await instance_leases(drt) != want:
        if time.monotonic() - t0 > timeout:
            fail(f"fleet: instances {await instance_leases(drt)} != {want}")
        await asyncio.sleep(0.02)
    return time.monotonic() - t0


async def worker_requests(port: int) -> float:
    return await worker_metric(port, "ingress_requests_total")


async def worker_metric(port: int, name: str) -> float:
    """One gauge of a worker's health-port /metrics (-1 when absent)."""
    import re

    from dynamo_tpu_torch.llm.http_client import fetch

    body = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()
    m = re.search(rf"^dyntpu_worker_{name} (\S+)$", body, re.M)
    return float(m.group(1)) if m else -1.0


KV_GROUPS = 4                 # kv_route leg: prefix groups
KV_PER_GROUP = 3              # requests per group (the first, then the later)
KV_PREFIX = 384               # shared prefix tokens (24 blocks of 16)
KV_SUFFIX = 64                # each request's own tokens
KV_BLOCK_BYTES = 16 * 2 * 16 * 8 * 64 * 2   # a llama3.2-1b KV block, bf16


def kv_groups(rng, vocab: int, groups: int) -> list[list[list[int]]]:
    """``groups`` × KV_PER_GROUP prompts: a shared KV_PREFIX-token prefix
    per group, a KV_SUFFIX-token suffix per request."""
    out = []
    for _ in range(groups):
        prefix = rng.integers(0, vocab, KV_PREFIX).tolist()
        out.append([prefix + rng.integers(0, vocab, KV_SUFFIX).tolist()
                    for _ in range(KV_PER_GROUP)])
    return out


def h2d_kv_rate(blocks: int = 64, iters: int = 20) -> dict:
    """Pinned host→device copy rate of a batch of llama3.2-1b KV blocks
    (CUDA events around ``iters`` non-blocking copies): the number behind
    the router's ``default_link_gbps``."""
    nbytes = blocks * KV_BLOCK_BYTES
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        dev.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    return {"blocks": blocks, "bytes": nbytes, "ms": ms, "gbps": nbytes / ms / 1e6}


async def send_groups(port, model, groups, max_tokens, tapped, greedy, settle) -> dict:
    """Each group's first request at once; ``settle()``; then every later
    request at once. Per request: stream summary, serving workers; per
    later request, the frontend's ``route`` span (the pick, KV decision
    and hit-rate publish included) from its finished trace."""
    from dynamo_tpu_torch.utils.tracing import tracer

    async def one(p):
        resp, timed = await http_stream(port, "/v1/completions", {
            "model": model, "prompt": p, "stream": True, "max_tokens": max_tokens,
            **greedy})
        return resp, stream_summary(timed)

    firsts = [g[0] for g in groups]
    later = [p for g in groups for p in g[1:]]
    got_first = await asyncio.gather(*[one(p) for p in firsts])
    await settle()
    got_later = await asyncio.gather(*[one(p) for p in later])
    done = dict(zip(map(tuple, firsts + later), got_first + got_later))
    ok = all(r.status == 200 and s["usage"]["completion_tokens"] == max_tokens
             and s["finish"] == "length" for r, s in done.values())
    spans = {tr["id"]: tr["spans"] for tr in tracer().snapshot(1024)["recent"]}
    route_ms = [sum(sp["dur_ms"] for sp in spans.get(tapped[tuple(p)]["id"], ())
                    if sp["name"] == "route") for p in later]
    return {
        "ok": ok,
        "route_ms_later": route_ms,
        "firsts_per_worker": sorted(
            sum(tapped[tuple(f)]["workers"][0] == w for f in firsts)
            for w in {tapped[tuple(f)]["workers"][0] for f in firsts}),
        "workers": {p: tapped[p]["workers"] for p in done},
        "ttft_first_ms": [s["times"][0] * 1e3 for _, s in got_first],
        "ttft_later_ms": [s["times"][0] * 1e3 for _, s in got_later],
    }


async def kv_route_leg(addr, stack, obs, bf16, cfg, params, port, tap, tapped, greedy,
                       max_tokens, rng) -> dict:
    """The KV-aware router on the two bf16 workers: see the module
    docstring (phase 9, kv_route). ``tap`` records each request's
    tokens, serving workers and id into ``tapped`` on both frontends."""
    import re

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.egress import PushRouter
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports import wire
    from dynamo_tpu_torch.tools import route_audit

    import signal

    t_leg = time.monotonic()
    health = {lease: hport for _, lease, hport, _ in bf16}
    children = []
    mport = free_port()
    router = await Child("router", ["router", "--control-plane", addr,
                                    "--endpoint", FLEET_ENDPOINT]).start()
    metrics = await Child("metrics", ["metrics", "--control-plane", addr, "--host",
                                      "127.0.0.1", "--port", str(mport)]).start()
    children += [router, metrics]
    try:
        # Both processes up before any traffic: their start-up (torch
        # imports) must not share the host with the timed requests.
        await router.wait_for(r"router service at dyn://dynamo\.router\.generate",
                              FLEET_WAIT_S)
        await metrics.wait_for(r"metrics exporter on", FLEET_WAIT_S)
        rate = h2d_kv_rate()
        emit({"phase": "fleet_kv_link", **rate,
              "router_default_link_gbps": KvRouterConfig().default_link_gbps})
        hits = await obs.bus.subscribe(
            obs.namespace("dynamo").component("torch").event_subject("kv-hit-rate"))
        stack.callback(hits.close)
        actuals: list[dict] = []

        async def collect():
            async for raw in hits:
                rec = wire.unpackb(raw)
                if rec.get("kind") == "actual":
                    actuals.append(rec)

        collector = asyncio.ensure_future(collect())
        stack.callback(collector.cancel)

        kv_args = cli.build_parser().parse_args([
            "run", "--in", "http", "--out", "dyn", "--control-plane", addr,
            "--router-mode", "kv", "--http-host", "127.0.0.1", "--http-port", "0"])
        cli.refuse_unserved(kv_args)
        kv_service, _ = await cli.start_http(kv_args, stack, engine_ops=(tap,))
        kv_port = kv_service.port
        await wait_model(kv_port, cfg.name)

        async def settle():
            """The router's indexer holds every first's blocks: no event
            pending and the radix size steady over 3 polls."""
            sizes = []
            t0 = time.monotonic()
            while True:
                g = ROUTE_OBS.gauges()
                sizes.append(g.get("kv_radix_blocks", 0))
                if (g.get("kv_events_pending", 1) == 0 and len(sizes) >= 3
                        and sizes[-1] == sizes[-3] > 0):
                    return
                if time.monotonic() - t0 > 30:
                    fail(f"fleet: kv_route: the indexer never settled {g}")
                await asyncio.sleep(0.05)

        async def reused() -> dict[int, float]:
            return {lease: await worker_metric(hp, "kv_reused_device_blocks_total")
                    for lease, hp in health.items()}

        groups = kv_groups(rng, cfg.vocab_size, KV_GROUPS)
        before_reuse = await reused()
        before_routes = ROUTE_OBS.snapshot(0)["routes_total"]
        kv = await send_groups(kv_port, cfg.name, groups, max_tokens, tapped, greedy,
                               settle)
        after_reuse = await reused()
        routes = (await fetch("127.0.0.1", kv_port, "GET",
                              f"/debug/routes?n={KV_GROUPS * KV_PER_GROUP}")).json()
        await until(lambda: len(actuals) >= len(routes["recent"]), 30,
                    "kv_route: the workers' actual-reuse records")
        prompts = [p for g in groups for p in g]
        by_id = {tapped[tuple(p)]["id"]: p for p in prompts}
        firsts = {tuple(g[0]) for g in groups}
        group_of = {tuple(p): tuple(g[0]) for g in groups for p in g}
        recs = [r for r in routes["recent"] if r["id"] in by_id]
        overlap_ok = len(recs) == len(prompts) and all(
            r["overlap_blocks"] == (0 if tuple(by_id[r["id"]]) in firsts
                                    else KV_PREFIX // 16) for r in recs)
        affinity = all(
            kv["workers"][tuple(p)] == kv["workers"][group_of[tuple(p)]]
            and len(kv["workers"][tuple(p)]) == 1 for p in prompts)
        report = route_audit.join_report(recs, [a for a in actuals if a.get("trace")])
        audit_fails = route_audit.run_asserts(report, 1.0)
        reuse_delta = sum(after_reuse.values()) - sum(before_reuse.values())
        streams = [tapped[tuple(p)]["tokens"][:max_tokens] for p in prompts]
        ref = teacher_forced(cfg, params, prompts, streams)
        ref.pop("first_token_ref_logprob")

        # The same traffic's shape through the round-robin frontend (fresh
        # prefixes: the KV leg's are cached now).
        rr_groups = kv_groups(rng, cfg.vocab_size, KV_GROUPS)
        before_rr = await reused()

        async def pause():
            await asyncio.sleep(0.5)

        rr = await send_groups(port, cfg.name, rr_groups, max_tokens, tapped, greedy,
                               pause)
        after_rr = await reused()

        # One more group through the standalone router (RouterService).
        via = await PushRouter.create(obs, "dyn://dynamo.router.generate")
        await via.client.wait_for_instances(30)
        svc_group = kv_groups(rng, cfg.vocab_size, 1)[0]
        req_before = {lease: await worker_requests(hp) for lease, hp in health.items()}
        reuse_before = await reused()

        async def through_router(p):
            pre = PreprocessedRequest(
                token_ids=p, sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=max_tokens, ignore_eos=True))
            toks = []
            async for item in via.generate(Context(pre.to_wire())):
                toks.extend(item.get("token_ids", []))
            return toks

        svc_streams = [await through_router(svc_group[0])]
        await asyncio.sleep(1.0)   # the first's KV events reach the router process
        svc_streams += await asyncio.gather(*[through_router(p) for p in svc_group[1:]])
        req_after = {lease: await worker_requests(hp) for lease, hp in health.items()}
        reuse_after = await reused()
        svc_split = sorted(req_after[k] - req_before[k] for k in health)
        svc_reuse = sum(reuse_after.values()) - sum(reuse_before.values())
        svc_ref = teacher_forced(cfg, params, svc_group, svc_streams)
        svc_ref.pop("first_token_ref_logprob")

        # The exporter's view of both workers.
        labels = 'namespace="dynamo",component="torch"'
        want = {lease: await worker_metric(hp, "kv_reused_device_blocks_total")
                for lease, hp in health.items()}
        t0 = time.monotonic()
        while True:
            text = (await fetch("127.0.0.1", mport, "GET", "/metrics")).body.decode()
            seen = {}
            for lease in health:
                m = re.search(rf'^dyntpu_kv_reused_device_blocks_total\{{{labels},'
                              rf'worker="{lease:x}"\}} (\S+)$', text, re.M)
                seen[lease] = float(m.group(1)) if m else None
            if seen == want or time.monotonic() - t0 > 15:
                break
            await asyncio.sleep(0.2)
        exporter_ok = seen == want and f"dyntpu_worker_count{{{labels}}} 2" in text

        for child in (router, metrics):
            child.signal(signal.SIGTERM)
        exits = [await child.exit_code(30) for child in (router, metrics)]
        result = {
            "groups": KV_GROUPS, "per_group": KV_PER_GROUP, "prefix_tokens": KV_PREFIX,
            "suffix_tokens": KV_SUFFIX, "max_tokens": max_tokens,
            "h2d_kv_link": rate,
            "later_on_first_worker": affinity,
            "route_records": len(recs),
            "predicted_overlaps": [r["overlap_blocks"] for r in recs],
            "workers_reused_blocks": reuse_delta,
            "route_audit": {k: report[k] for k in (
                "routes", "actuals", "joined", "join_rate", "orphan_routes",
                "overlap_error", "staleness", "decision_ms")},
            "route_audit_failures": audit_fails,
            "metrics_stale": routes["gauges"].get("kv_router_metrics_stale"),
            "indexer": {k: routes["gauges"].get(k) for k in (
                "kv_events_applied_total", "kv_radix_blocks", "kv_event_lag_p50_ms",
                "kv_event_lag_p99_ms")},
            "ttft_later_p50_ms": float(np.median(kv["ttft_later_ms"])),
            "ttft_first_p50_ms": float(np.median(kv["ttft_first_ms"])),
            "ttft_later_ms": kv["ttft_later_ms"],
            "route_span_later_p50_ms": float(np.median(kv["route_ms_later"])),
            "firsts_per_worker": kv["firsts_per_worker"],
            "round_robin": {
                "ttft_later_ms": rr["ttft_later_ms"],
                "route_span_later_p50_ms": float(np.median(rr["route_ms_later"])),
                "firsts_per_worker": rr["firsts_per_worker"],
                "reused_blocks": sum(after_rr.values()) - sum(before_rr.values()),
                "ttft_later_p50_ms": float(np.median(rr["ttft_later_ms"])),
                "ttft_first_p50_ms": float(np.median(rr["ttft_first_ms"])),
                "later_on_first_worker": sum(
                    rr["workers"][tuple(p)] == rr["workers"][tuple(g[0])]
                    for g in rr_groups for p in g[1:]),
            },
            "router_service": {"split": svc_split, "reused_blocks": svc_reuse,
                               **svc_ref},
            "exporter_ok": exporter_ok, "exporter_values": {
                f"{k:x}": v for k, v in seen.items()},
            "subprocess_exit_codes": exits,
            **ref,
            "leg_s": time.monotonic() - t_leg,
        }
        emit({"phase": "fleet_kv_route", **result})
        gates = {
            "counts": kv["ok"] and rr["ok"],
            "affinity": affinity,
            "route_records": overlap_ok,
            "reuse_192": reuse_delta == (KV_GROUPS * (KV_PER_GROUP - 1)
                                         * KV_PREFIX // 16),
            "audit_exact": not audit_fails and report["joined"] == len(prompts)
            and report["overlap_error"]["abs_max"] == 0,
            "metrics_fresh": routes["gauges"].get("kv_router_metrics_stale") == 0,
            "agreement": ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS,
            "router_service": svc_split == [0.0, float(KV_PER_GROUP)]
            and svc_reuse == (KV_PER_GROUP - 1) * KV_PREFIX // 16
            and svc_ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and svc_ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS,
            "exporter": exporter_ok,
            "exits": exits == [0, 0],
        }
        if not all(gates.values()):
            fail(f"fleet: kv_route gates {gates}")
        return result
    finally:
        for child in children:
            await child.kill()


async def worker_exit(child, timeout: float = 120.0) -> dict:
    """A drained worker's end: "drain complete", exit code 0, and its
    ``worker report`` line (requests, dispatches, launch counts, memory)."""
    import re

    _, t_done = await child.wait_for(r"^drain complete", timeout)
    rc = await child.exit_code(timeout)
    m, _ = await child.wait_for(r"^worker report (\{.*\})", 5)
    if rc != 0:
        fail(f"fleet: {child.name} exited {rc}:\n{child.tail()}")
    report = json.loads(m.group(1))
    report["exit_code"] = rc
    report["drain_complete_s"] = t_done - child.t_spawn
    return report


def launches_ok(report: dict, walk_path: bool) -> bool:
    """The worker's ragged wrapper launched num_layers times per dispatch,
    every call on the split path and on the tile (bf16) or walk (f32)."""
    k = report["kernel_launches"]
    n = k["ragged_paged_attention_cuda.launches"]
    tile = k["ragged_paged_attention_cuda.launches_walk" if walk_path
             else "ragged_paged_attention_cuda.launches_tc"]
    other = k["ragged_paged_attention_cuda.launches_tc" if walk_path
              else "ragged_paged_attention_cuda.launches_walk"]
    return (report["unified_dispatches"] > 0 and report["device"] == "cuda"
            and n == report["num_layers"] * report["unified_dispatches"]
            and tile == n and k["ragged_paged_attention_cuda.launches_split"] == n
            and other == 0)


async def serve_prompts(port, model, prompts, max_tokens, tapped, greedy) -> dict:
    """The prompts as concurrent streaming /v1/completions through the
    frontend; the client's numbers, the tapped streams and their workers,
    and whether every count is right."""
    t0 = time.perf_counter()
    streamed = await asyncio.gather(*[
        http_stream(port, "/v1/completions",
                    {"model": model, "prompt": p, "stream": True,
                     "max_tokens": max_tokens, **greedy}) for p in prompts])
    wall = time.perf_counter() - t0
    summaries = [stream_summary(timed) for _, timed in streamed]
    served_by = [tapped[tuple(p)]["workers"] for p in prompts]
    counts_ok = (
        all(r.status == 200 for r, _ in streamed)
        and all(s["usage"]["completion_tokens"] == max_tokens and s["finish"] == "length"
                and len(s["times"]) == max_tokens for s in summaries)
        and all(len(tapped[tuple(p)]["tokens"]) == max_tokens for p in prompts))
    ttft = [s["times"][0] for s in summaries]
    itl = [b - a for s in summaries for a, b in zip(s["times"], s["times"][1:])]
    by_worker: dict[str, list[float]] = {}
    for s, w in zip(summaries, served_by):
        by_worker.setdefault(f"{w[0]:#x}", []).extend(
            b - a for a, b in zip(s["times"], s["times"][1:]))
    return {
        "wall_s": wall, "tokens_per_s": len(prompts) * max_tokens / wall,
        "client_ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "client_ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
        "client_itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
        "client_itl_p95_ms": float(np.percentile(itl, 95)) * 1e3,
        "client_itl_by_worker_ms": {
            w: {"p50": float(np.percentile(g, 50)) * 1e3,
                "p95": float(np.percentile(g, 95)) * 1e3}
            for w, g in by_worker.items()},
        "counts_ok": counts_ok,
        "streams": [tapped[tuple(p)]["tokens"][:max_tokens] for p in prompts],
    }


class _LogTimes(logging.Handler):
    """Arrival time (perf_counter) of each record of one logger: when
    the frontend saw a worker die, when it re-dispatched."""

    def __init__(self) -> None:
        super().__init__()
        self.times: list[tuple[float, str]] = []

    def emit(self, record) -> None:
        self.times.append((time.perf_counter(), record.getMessage()))


def choice_events(timed) -> list[float]:
    out = []
    for t, ev in timed:
        if ev.data != "[DONE]" and json.loads(ev.data).get("choices"):
            out.append(t)
    return out


async def phase_fleet(prompts, max_tokens, http, params, seed: int = 1) -> dict:
    """The runtime plane on the card: see the module docstring (phase 9).
    Legs run serve, drain verb, SIGTERM (the two bf16 workers), then the
    float32 failover pair."""
    import signal

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.drain import request_drain
    from dynamo_tpu_torch.runtime.failover import FAILOVER
    from dynamo_tpu_torch.runtime.pipeline import Tap

    cfg = ModelConfig.llama32_1b()
    tapped: dict[tuple, dict] = {}   # prompt token ids -> tokens, workers

    def on_request(ctx):
        tapped[tuple(ctx.payload["token_ids"])] = {
            "tokens": [], "workers": [], "id": ctx.id}

    def on_response(ctx, item):
        rec = tapped[tuple(ctx.payload["token_ids"])]
        wid = ctx.annotations.get("worker_id")
        if not rec["workers"] or rec["workers"][-1] != wid:
            rec["workers"].append(wid)
        rec["tokens"].extend(item["token_ids"])

    tap = Tap(on_request, on_response)
    greedy = {"temperature": 0, "nvext": {"ignore_eos": True}}
    children: list = []
    result: dict = {"phase": "fleet", "model": cfg.name}
    cp = Child("control plane", ["control-plane", "--host", "127.0.0.1", "--port", "0"])
    children.append(cp)
    obs = None
    try:
        await cp.start()
        addr = (await cp.wait_for(r"control plane on (\S+)", 120))[0].group(1)
        obs = await DistributedRuntime.connect(addr)
        async with contextlib.AsyncExitStack() as stack:
            args = cli.build_parser().parse_args([
                "run", "--in", "http", "--out", "dyn", "--control-plane", addr,
                "--http-host", "127.0.0.1", "--http-port", "0"])
            cli.refuse_unserved(args)
            service, _ = await cli.start_http(args, stack, engine_ops=(tap,))
            port = service.port

            # -- leg 1: serve through two bf16 workers ----------------------------
            puts = await watch_puts(obs, stack)
            bf16 = await spawn_workers(addr, 2, "bfloat16", "bf16-")
            children += [w[0] for w in bf16]
            await wait_leases(obs, {w[1] for w in bf16})
            discovery = [puts[lease] - child.t_spawn for child, lease, *_ in bf16]
            await wait_model(port, cfg.name)
            served = await serve_prompts(port, cfg.name, prompts, max_tokens, tapped, greedy)
            split = [await worker_requests(w[2]) for w in bf16]
            streams = served.pop("streams")
            ref = teacher_forced(cfg, params, list(prompts), streams)
            ref.pop("first_token_ref_logprob")
            result["serve"] = {
                "workers": [{"lease": f"{lease:#x}", "startup_s": up,
                             "discovery_s": d, "requests": n}
                            for (_, lease, _, up), d, n in zip(bf16, discovery, split)],
                "requests": len(prompts), "max_tokens": max_tokens, **served,
                "http_phase": {k: http[k] for k in (
                    "tokens_per_s", "client_ttft_p50_ms", "client_itl_p50_ms",
                    "client_itl_p95_ms")},
                **ref,
                "greedy_match_rate_vs_http": match_rate(streams, http["streams"]),
                "gates": {"agreement_min": PHASES_AGREEMENT, "gap_max": NEAR_TIE_NATS},
            }
            counts_ok = served["counts_ok"]
            emit({"phase": "fleet_serve", **result["serve"]})
            if not counts_ok or sorted(split) != [4.0, 4.0]:
                fail(f"fleet: serve counts {counts_ok}, split {split}")
            if not (ref["logits_finite"] and ref["logits_shape_ok"]
                    and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
                    and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
                fail("fleet: streams disagree with the no-cache reference")

            # -- kv_route: the KV-aware router on the same two workers -------
            result["kv_route"] = await kv_route_leg(
                addr, stack, obs, bf16, cfg, params, port, tap, tapped, greedy,
                max_tokens, np.random.default_rng([seed, 9]))

            # -- legs 3 and 4: the drain verb, then SIGTERM on the last ----------
            by_lease = {w[1]: w for w in bf16}
            reports = {}
            legs = {}
            for how in ("drain_verb", "sigterm"):
                live = await instance_leases(obs)
                prompt = prompts[0 if how == "drain_verb" else 1]
                nxt = prompts[2 if how == "drain_verb" else 3]
                tapped.pop(tuple(prompt), None)
                tapped.pop(tuple(nxt), None)
                long_tokens = 256
                inflight = asyncio.ensure_future(http_stream(
                    port, "/v1/completions",
                    {"model": cfg.name, "prompt": prompt, "stream": True,
                     "max_tokens": long_tokens, **greedy}))
                await until(lambda: len(tapped.get(tuple(prompt), {}).get("tokens", [])) >= 8
                            or inflight.done(), 60, f"{how}: 8 tokens in flight")
                if inflight.done():
                    fail(f"fleet: {how} stream ended early: {inflight.result()[0].status}")
                lease = tapped[tuple(prompt)]["workers"][0]
                child = by_lease[lease][0]
                if how == "drain_verb":
                    await request_drain(obs, "dynamo", "torch", lease_id=lease)
                else:
                    child.signal(signal.SIGTERM)
                deregistered = asyncio.ensure_future(wait_leases(obs, live - {lease}))
                resp, timed = await inflight
                t_stream_done = time.monotonic()
                summ = stream_summary(timed)
                report = await worker_exit(child)
                reports[f"{lease:#x}"] = report
                leg = {"lease": f"{lease:#x}", "inflight_status": resp.status,
                       "inflight_tokens": summ["usage"]["completion_tokens"],
                       "inflight_finish": summ["finish"],
                       "deregistered_after_s": await deregistered,
                       "exit_after_stream_s": time.monotonic() - t_stream_done,
                       "exit_code": report["exit_code"]}
                r = await fetch("127.0.0.1", port, "POST", "/v1/completions",
                                {"model": cfg.name, "prompt": nxt, "max_tokens": 8, **greedy})
                leg["next_status"] = r.status
                if how == "drain_verb":
                    leg["next_served_by"] = f"{tapped[tuple(nxt)]['workers'][0]:#x}"
                legs[how] = leg
                ok = (resp.status == 200 and leg["inflight_tokens"] == long_tokens
                      and summ["finish"] == "length")
                if how == "drain_verb":
                    ok &= r.status == 200 and tapped[tuple(nxt)]["workers"][0] != lease
                else:
                    # No instance left: the model is gone (404) or the
                    # router finds no live instance (503).
                    ok &= r.status in (404, 503)
                if not ok:
                    fail(f"fleet: {how} leg {leg}")
                if how == "drain_verb":
                    # The same 8 requests through the one worker left: the
                    # hop's cost beside the http phase's in-process serve,
                    # without a second process on the card.
                    for p in prompts:
                        tapped.pop(tuple(p), None)
                    one = await serve_prompts(port, cfg.name, prompts, max_tokens,
                                              tapped, greedy)
                    one_streams = one.pop("streams")
                    one_ref = teacher_forced(cfg, params, list(prompts), one_streams)
                    one_ref.pop("first_token_ref_logprob")
                    result["serve_one_worker"] = {**one, **one_ref}
                    emit({"phase": "fleet_serve_one_worker", **result["serve_one_worker"]})
                    if not (one["counts_ok"] and one_ref["logits_finite"]
                            and one_ref["greedy_agreement_vs_no_cache_reference"]
                            >= PHASES_AGREEMENT
                            and one_ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
                        fail("fleet: one-worker serve failed its gates")
            launches = {w: launches_ok(rep, walk_path=False) for w, rep in reports.items()}
            result["drain"] = legs
            result["bf16_workers"] = reports
            emit({"phase": "fleet_drain", "legs": legs, "worker_reports": reports,
                  "launches_ok": launches})
            if not all(launches.values()):
                fail(f"fleet: bf16 worker launches {launches}")

            # -- leg 2: failover between two float32 workers -------------------
            f32 = await spawn_workers(addr, 2, "float32", "f32-")
            children += [w[0] for w in f32]
            await wait_leases(obs, {w[1] for w in f32})
            await wait_model(port, cfg.name)
            fo_prompt, fo_tokens = [11, 22, 33, 44], 64
            body = {"model": cfg.name, "prompt": fo_prompt, "stream": True,
                    "max_tokens": fo_tokens, **greedy}
            ref_resp, ref_timed = await http_stream(port, "/v1/completions", body)
            ref_stream = list(tapped[tuple(fo_prompt)]["tokens"])
            ref_worker = tapped[tuple(fo_prompt)]["workers"]
            before = dict(FAILOVER.success_by_reason), FAILOVER.total
            eighth = asyncio.Event()
            arrivals: list[float] = []

            def on_event(t, ev):
                if ev.data != "[DONE]" and json.loads(ev.data).get("choices"):
                    arrivals.append(time.perf_counter())
                    if len(arrivals) == 8:
                        eighth.set()

            tapped.pop(tuple(fo_prompt))
            seen = _LogTimes()
            logging.getLogger("dynamo_tpu_torch.runtime.failover").addHandler(seen)
            run = asyncio.ensure_future(http_stream(port, "/v1/completions", body, on_event))
            await asyncio.wait_for(eighth.wait(), 60)
            victim_lease = tapped[tuple(fo_prompt)]["workers"][0]
            victim = next(w[0] for w in f32 if w[1] == victim_lease)
            t_kill = time.perf_counter()
            victim.signal(signal.SIGKILL)
            got_resp, got_timed = await run
            summ = stream_summary(got_timed)
            got_stream = tapped[tuple(fo_prompt)]["tokens"]
            workers_seen = tapped[tuple(fo_prompt)]["workers"]
            logging.getLogger("dynamo_tpu_torch.runtime.failover").removeHandler(seen)
            t_detect = next((t for t, msg in seen.times if "died mid-stream" in msg), None)
            before_kill = [t for t in arrivals if t <= t_kill]
            after_kill = [t for t in arrivals if t > t_kill]
            gap = (after_kill[0] - before_kill[-1]) if after_kill and before_kill else None
            succ = FAILOVER.success_by_reason.get("WorkerDiedError", 0) - before[0].get(
                "WorkerDiedError", 0)
            survivor = next(w for w in f32 if w[1] != victim_lease)
            survivor[0].signal(signal.SIGTERM)
            f32_report = await worker_exit(survivor[0])
            await victim.exit_code(30)
            result["failover"] = {
                "prompt": fo_prompt, "max_tokens": fo_tokens, "dtype": "float32",
                "workers": [{"lease": f"{lease:#x}", "startup_s": up}
                            for _, lease, _, up in f32],
                "reference_served_by": [f"{w:#x}" for w in ref_worker],
                "killed": f"{victim_lease:#x}", "tokens_before_kill": len(before_kill),
                "served_by": [f"{w:#x}" for w in workers_seen],
                "status": got_resp.status, "tokens": summ["usage"]["completion_tokens"],
                "finish": summ["finish"],
                "byte_identical_to_uninterrupted": got_stream == ref_stream,
                "failover_successes_worker_died": succ,
                "failover_attempts": FAILOVER.total - before[1],
                "gap_at_client_ms": gap * 1e3 if gap is not None else None,
                "kill_to_death_seen_ms": (t_detect - t_kill) * 1e3 if t_detect else None,
                "death_seen_to_next_token_ms": (after_kill[0] - t_detect) * 1e3
                if t_detect and after_kill else None,
                "reference_itl_p50_ms": float(np.median(np.diff(choice_events(ref_timed)))) * 1e3,
                "survivor_report": f32_report,
                "survivor_launches_ok": launches_ok(f32_report, walk_path=True),
            }
            emit({"phase": "fleet_failover", **result["failover"]})
            fo = result["failover"]
            sv = result["serve"]
            result["summary"] = {
                "worker_startup_s": [w["startup_s"] for w in sv["workers"]]
                + [w["startup_s"] for w in fo["workers"]],
                "worker_discovery_s": [w["discovery_s"] for w in sv["workers"]],
                "client_ttft_ms": {"p50": sv["client_ttft_p50_ms"],
                                   "p95": sv["client_ttft_p95_ms"],
                                   "http_phase_p50": http["client_ttft_p50_ms"]},
                "client_itl_ms": {"p50": sv["client_itl_p50_ms"],
                                  "p95": sv["client_itl_p95_ms"],
                                  "http_phase_p50": http["client_itl_p50_ms"],
                                  "http_phase_p95": http["client_itl_p95_ms"]},
                "tokens_per_s": sv["tokens_per_s"],
                "http_phase_tokens_per_s": http["tokens_per_s"],
                "one_worker": {k: result["serve_one_worker"][k] for k in (
                    "tokens_per_s", "client_ttft_p50_ms", "client_itl_p50_ms",
                    "client_itl_p95_ms")},
                "failover_gap_ms": fo["gap_at_client_ms"],
                "failover_kill_to_death_seen_ms": fo["kill_to_death_seen_ms"],
                "failover_death_seen_to_next_token_ms": fo["death_seen_to_next_token_ms"],
                "worker_cuda_max_allocated_gb": {
                    w: r.get("cuda_max_allocated_bytes", 0) / 1e9
                    for w, r in {**reports, f"{survivor[1]:#x}": f32_report}.items()},
            }
            emit({"phase": "fleet", **result["summary"]})
            if not (ref_resp.status == 200 and len(ref_stream) == fo_tokens
                    and fo["status"] == 200 and fo["tokens"] == fo_tokens
                    and fo["finish"] == "length" and fo["byte_identical_to_uninterrupted"]
                    and succ == 1 and len(workers_seen) == 2 and gap is not None
                    and fo["survivor_launches_ok"]):
                fail(f"fleet: failover leg {fo}")
    finally:
        if obs is not None:
            await obs.shutdown()
        for child in children:
            await child.kill()
    return result


async def until(cond, timeout: float, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            fail(f"fleet: timed out waiting for {what}")
        await asyncio.sleep(0.002)


async def watch_puts(drt, stack) -> dict[int, float]:
    """{lease: arrival time of its instance key's PUT} from a watch on the
    endpoint's instances, as the frontend's router watches them."""
    from dynamo_tpu_torch.runtime.transports.store import EventKind

    watch = await drt.store.watch_prefix("instances/dynamo/torch/generate:")
    puts: dict[int, float] = {}

    async def pump():
        async for ev in watch:
            if ev.kind is EventKind.PUT:
                puts.setdefault(int(ev.key.rsplit(":", 1)[1], 16), time.monotonic())

    task = asyncio.ensure_future(pump())
    stack.callback(task.cancel)
    stack.callback(watch.cancel)
    return puts


async def wait_model(port: int, name: str, timeout: float = 30.0) -> None:
    from dynamo_tpu_torch.llm.http_client import fetch

    t0 = time.monotonic()
    while name not in [m["id"] for m in (await fetch(
            "127.0.0.1", port, "GET", "/v1/models")).json()["data"]]:
        if time.monotonic() - t0 > timeout:
            fail(f"fleet: the frontend never listed {name}")
        await asyncio.sleep(0.05)


# -- phase 10: disaggregation and the KVBM tiers ------------------------------
DISAGG_MAX_LEN = 2048         # the disagg engines' max_model_len (1536 + 32 fits)
DISAGG_LONG = (1024, 1537)    # remote prompts: 4, tokens in [1024, 1536]
DISAGG_SHORT = (64, 257)      # local prompts: 4, tokens in [64, 256]
DISAGG_LOCAL_MAX = 512        # DisaggConfig.max_local_prefill_length
KVBM_GROUPS = 2               # the kvbm leg: prefix groups ...
KVBM_PER_GROUP = 4            # ... of 4 prompts ...
KVBM_PREFIX = 512             # ... sharing 512 tokens (32 blocks) ...
KVBM_SUFFIX = 64              # ... each with 64 of its own
G4_SLACK_S = 5.0              # g4 leg (c): recompute + decode after the park deadline
G4_HOLD_S = 3.0               # g4 leg (c): the kvbm.peer_pull delay holding the pull
WORKER_ARGS = ["--model-path", "preset:llama3.2-1b", "--max-model-len", str(DISAGG_MAX_LEN),
               "--num-blocks", "1024", "--max-num-seqs", "8", "--prefill-batch", "4",
               "--unified-token-budget", "256", "--seed", "0", "--warmup"]


def disagg_config(**kw):
    return full_width_config(max_model_len=DISAGG_MAX_LEN, **kw)


def disagg_prompts(seed: int, vocab: int) -> list[list[int]]:
    """4 long prompts (remote) then 4 short ones (local), from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(*DISAGG_LONG, 4)) + list(rng.integers(*DISAGG_SHORT, 4))
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def stream_gates(leg: str, cfg, params, prompts, streams, finishes, max_tokens,
                 limits=None, mm=None) -> dict:
    """Full-length greedy streams in the vocabulary, held to the no-cache
    reference as the phase-split run is: agreement >= 0.9, every
    disagreement a near tie; or, where given, to ``limits`` = (agreement
    at least, largest gap at a disagreement at most). ``mm`` as
    ``teacher_forced`` takes it."""
    from dynamo_tpu_torch.llm.protocols.common import FinishReason

    ref = teacher_forced(cfg, params, prompts, streams, mm)
    ref.pop("first_token_ref_logprob")
    full = all(len(s) == max_tokens for s in streams) and all(
        f is FinishReason.LENGTH for f in finishes)
    in_vocab = all(0 <= t < cfg.vocab_size for s in streams for t in s)
    agree_min, gap_max = limits or (PHASES_AGREEMENT, NEAR_TIE_NATS)
    if not (full and in_vocab and ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= agree_min
            and ref["max_logprob_gap_at_disagreement"] <= gap_max):
        fail(f"{leg}: streams failed their checks (full {full}, in vocab "
             f"{in_vocab})", {"agreement": ref["greedy_agreement_vs_no_cache_reference"],
                              "gap": ref["max_logprob_gap_at_disagreement"]},
             {"agreement_min": agree_min, "gap_max": gap_max})
    return ref


def span_ms(path: str, name: str) -> list[float]:
    """Durations of every ``name`` span of one process's trace capture, in
    the order they were recorded."""
    from dynamo_tpu_torch.utils.recorder import Recorder

    return [float(ev["dur_ms"]) for _ts, ev in Recorder.load(path)
            if ev.get("kind") == "span" and ev.get("span") == name]


def pct(xs: list[float], q: float) -> float | None:
    return float(np.percentile(xs, q)) if xs else None


def device_crc_match(sender, receiver, prompts) -> dict:
    """Each remote prompt's full blocks: the receiving engine's bytes
    against the sending engine's (both caches hold the prompt under the
    same block hashes), by CRC. Returns counts."""
    from dynamo_tpu_torch.block_manager.integrity import block_checksum
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

    same = total = 0
    bs = sender.cfg.block_size
    for p in prompts:
        hashes = TokenBlockSequence.from_tokens(p, block_size=bs).sequence_hashes()[
            : len(p) // bs]
        ids = [(sender.allocator._hash_to_block.get(h), receiver.allocator._hash_to_block.get(h))
               for h in hashes]
        ids = [(a, b) for a, b in ids if a is not None and b is not None]
        if not ids:
            continue
        got_a = sender.runner.gather_many([a for a, _ in ids])
        got_b = receiver.runner.gather_many([b for _, b in ids])
        for x, y in zip(got_a, got_b):
            total += 1
            same += block_checksum(x) == block_checksum(y)
    return {"blocks_compared": total, "blocks_crc_equal": same}


async def disagg_leg(name, decode, queue, transport, prompts, max_tokens, params,
                     prefill=None, worker=None) -> dict:
    """The 8 prompts through a DecodeOperator pinned to ``transport``: 4
    remote, 4 local; the receivers' counters name the transport that
    carried the blocks; the ragged kernel's launches are counted over the
    leg on this process's engines (and read from the worker's report
    when the prefill engine is a process of its own)."""
    from dynamo_tpu_torch.block_manager.integrity import INTEGRITY
    from dynamo_tpu_torch.disagg import DecodeOperator, DisaggConfig, DisaggRouter
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    router = DisaggRouter.__new__(DisaggRouter)
    router.cfg = DisaggConfig(max_local_prefill_length=DISAGG_LOCAL_MAX,
                              max_prefill_queue_size=64)
    # Staging slots for 4 remote prompts of up to 97 blocks at once (the
    # native transport reserves one per block; 512 KiB each).
    op = await DecodeOperator(decode, queue, router, transport=transport,
                              staging_slots=512).start()
    INTEGRITY.reset()
    engines = [decode] + ([prefill] if prefill is not None else [])
    d0 = [e.unified_dispatches for e in engines]
    reset_counts()
    try:
        streams, finishes, ttft, wall = await serve(op, prompts, max_tokens)
    finally:
        await op.stop()
    launches = fn.launches
    paths = {"tc": fn.launches_tc, "split": fn.launches_split, "walk": fn.launches_walk}
    dispatches = [e.unified_dispatches - d for e, d in zip(engines, d0)]
    cfg = decode.cfg.model
    receivers = {"device": op.device_receiver, "native": op.receiver if op.transport == "native"
                 else None, "tcp": op.tcp_receiver or (op.receiver if op.transport == "tcp"
                                                      else None)}
    carried = {k: (r.blocks_received if r is not None else 0) for k, r in receivers.items()}
    nbytes = {k: (r.bytes_received if r is not None else 0) for k, r in receivers.items()}
    bs = decode.cfg.block_size
    want_blocks = sum((len(p) + bs - 1) // bs for p in prompts[:4])
    out = {
        "leg": name, "transport": transport, "remote_count": op.remote_count,
        "local_count": op.local_count, "blocks_received": carried,
        "bytes_received": nbytes, "expected_blocks": want_blocks,
        "integrity": INTEGRITY.snapshot(), "wall_s": wall,
        "ttft_remote_p50_ms": float(np.median(ttft[:4])) * 1e3,
        "ttft_local_p50_ms": float(np.median(ttft[4:])) * 1e3,
        "ttft_ms": [t * 1e3 for t in ttft],
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "kernel_launches_by_path": paths,
        "mid_traffic_compiles": [mid_traffic(e) for e in engines],
        "degraded_requests": decode.degraded_requests,
    }
    if (op.remote_count, op.local_count) != (4, 4):
        fail(f"disagg {name}: remote/local {op.remote_count}/{op.local_count}")
    if carried[transport] != want_blocks or sum(carried.values()) != want_blocks:
        fail(f"disagg {name}: blocks carried {carried}, want {want_blocks} "
                         f"on {transport} only")
    if out["integrity"]["integrity_failures_total"] or decode.degraded_requests:
        fail(f"disagg {name}: integrity {out['integrity']}, "
                         f"degraded {decode.degraded_requests}")
    if launches != cfg.num_layers * sum(dispatches) or 0 in dispatches:
        fail(f"disagg {name}: ragged kernel launched {launches} times for "
                         f"{dispatches} dispatches x {cfg.num_layers} layers")
    want_paths = {"tc": launches, "split": launches, "walk": 0}
    if decode.cfg.dtype == "bfloat16" and paths != want_paths:
        fail(f"disagg {name}: ragged paths {paths}")
    if any(out["mid_traffic_compiles"]):
        fail(f"disagg {name}: graphs captured mid-traffic "
                         f"{out['mid_traffic_compiles']}")
    out.update(stream_gates(name, cfg, params, prompts, streams, finishes, max_tokens))
    out["streams"] = streams
    return out


async def worker_done(child, leg: str, served: int) -> dict:
    """SIGTERM a prefill worker; its report: every dispatch launched the
    ragged kernel once per layer, nothing was captured mid-traffic."""
    import json as _json
    import signal as _signal

    child.signal(_signal.SIGTERM)
    rc = await child.exit_code(120)
    m, _ = await child.wait_for(r"worker report (\{.*\})", 5)
    rep = _json.loads(m.group(1))
    launches = rep["kernel_launches"]["ragged_paged_attention_cuda.launches"]
    rep["ragged_launches"] = launches
    if (rc != 0 or rep["requests"] != served or rep["mid_traffic_compiles"]
            or launches != rep["num_layers"] * rep["unified_dispatches"]
            or not rep["unified_dispatches"]):
        fail(f"disagg {leg}: prefill worker rc {rc}, report {rep}")
    return rep


async def kvbm_leg(vocab: int, max_tokens: int, params) -> dict:
    """An engine with a KvBlockManager (a G2 host tier, a G3 disk tier in
    a temporary directory): 8 prompts sharing two 512-token prefixes
    served cold, the device cache cleared and the prompts served again
    (the first time the adaptive gate decides, then with its estimates
    in), the onboarded blocks held to the offered rows by CRC; then the
    host tier spilled and a two-touch disk promotion brought back through
    G3 with its envelope verified."""
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig
    from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    rng = np.random.default_rng(5)
    prompts = []
    for _ in range(KVBM_GROUPS):
        prefix = rng.integers(0, vocab, KVBM_PREFIX).tolist()
        prompts += [prefix + rng.integers(0, vocab, KVBM_SUFFIX).tolist()
                    for _ in range(KVBM_PER_GROUP)]
    ecfg = disagg_config()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kvbm_")
    INTEGRITY.reset()
    kvbm = await KvBlockManager(KvbmConfig(
        layout=KvLayoutConfig.for_engine(ecfg, quant=None), host_blocks=256,
        disk_blocks=512, disk_path=os.path.join(tmp, "g3.kv"),
    )).start()
    engine = TorchEngine(ecfg, device=DEVICE, block_manager=kvbm)
    await engine.start()
    out: dict = {"leg": "kvbm", "prompts": len(prompts)}
    try:
        await warm_up(engine)

        async def run_pass(name):
            await engine.wait_drained(30)
            r0 = {k: engine.readiness()[k] for k in (
                "kv_reused_device_blocks_total", "kv_reused_host_blocks_total",
                "kv_reused_disk_blocks_total")}
            d0 = engine.unified_dispatches
            reset_counts()
            streams, finishes, ttft, wall = await serve(engine, prompts, max_tokens)
            await engine.wait_drained(30)
            await kvbm.drain_offers()
            rd = engine.readiness()
            dispatches = engine.unified_dispatches - d0
            if fn.launches != ecfg.model.num_layers * dispatches or not dispatches:
                fail(f"disagg kvbm {name}: ragged kernel launched "
                                 f"{fn.launches} times for {dispatches} dispatches")
            out["ragged_launches"] = out.get("ragged_launches", 0) + fn.launches
            out[name] = {
                "ttft_p50_ms": float(np.median(ttft)) * 1e3, "wall_s": wall,
                "unified_dispatches": dispatches,
                "prefill_tokens_total": engine.unified_prefill_tokens,
                **{k: rd[k] - r0[k] for k in r0},
                "onboard_skips": engine._onboard_skips,
                "onboard_probes": engine._onboard_probes,
            }
            return streams, finishes

        cold, cold_fin = await run_pass("cold")
        stream_gates("kvbm_cold", ecfg.model, params, prompts, cold, cold_fin, max_tokens)
        offered = {h: kvbm.host_pool.get_by_hash(h).checksum
                   for h in kvbm.host_pool.registered_hashes()}
        out["offered_blocks"] = len(offered)
        # Twice with the adaptive gate deciding (its first pass probes, the
        # second has its rate estimates), then with the gate off: every
        # host hit onboards, the TTFT of a host hit against recompute.
        for name in ("host_gate_first", "host_gate", "host"):
            engine.cfg.kvbm_adaptive_gate = name != "host"
            engine.allocator.clear_reusable()
            streams, fin = await run_pass(name)
            stream_gates(f"kvbm_{name}", ecfg.model, params, prompts, streams, fin,
                         max_tokens)
        # The onboarded blocks, read back from the device cache, are the
        # rows the tier was offered (same CRC): every prompt's blocks
        # below its last full one (that one is always recomputed).
        from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

        onboardable = set()
        for p in prompts:
            hs = TokenBlockSequence.from_tokens(p, block_size=16).sequence_hashes()
            onboardable.update(hs[: (len(p) - 1) // 16])
        ids = [(h, engine.allocator._hash_to_block[h]) for h in offered
               if h in onboardable and h in engine.allocator._hash_to_block]
        rows = engine.runner.gather_many([b for _, b in ids])
        same = sum(block_checksum(r) == offered[h] for (h, _), r in zip(ids, rows))
        out["device_vs_offered_crc"] = {"compared": len(ids), "equal": same}
        out["onboard_gbps"] = (engine._onboard_bps or 0.0) / 1e9
        out["prefill_tps"] = engine._prefill_tps
        # Spill G2 (LRU pressure): the prefixes live on G3 only; touch 1
        # recomputes and requests their promotion, touch 2 onboards them.
        await kvbm._g2_to_g3.drain()
        for b in kvbm.host_pool.allocate_blocks(kvbm.host_pool.num_free):
            kvbm.host_pool.release(b)
        for name in ("disk_touch1", "disk_touch2"):
            engine.allocator.clear_reusable()
            streams, fin = await run_pass(name)
            stream_gates(f"kvbm_{name}", ecfg.model, params, prompts, streams, fin,
                         max_tokens)
        st = kvbm.stats()
        out["stats"] = {k: v for k, v in st.items() if not k.startswith("quant")}
        out["integrity"] = INTEGRITY.snapshot()
    finally:
        await engine.stop()
        await kvbm.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    h = out["host"]
    if (len(offered) != KVBM_GROUPS * KVBM_PREFIX // 16 + len(prompts) * KVBM_SUFFIX // 16
            or not h["kv_reused_host_blocks_total"]
            or out["device_vs_offered_crc"]["equal"] != out["device_vs_offered_crc"][
                "compared"] or not out["device_vs_offered_crc"]["compared"]
            or out["stats"]["promotions_requested_total"] == 0
            or out["stats"]["promoted_blocks_total"] == 0
            or out["integrity"]["integrity_failures_total"]):
        fail(f"disagg kvbm: gates failed {out}")
    return out


async def g4_leg(vocab: int, max_tokens: int, params, address: str) -> dict:
    """The G4 peer tier between three llama3.2-1b engines (A, B, C), each
    with its own KvBlockManager (G2) and its own runtime on the phase's
    control plane at ``address``: see the module docstring (phase 10, g4).
    Returns the leg's report; a failed gate raises SystemExit."""
    from dynamo_tpu_torch.block_manager import (
        KvbmConfig,
        KvBlockManager,
        KvLayoutConfig,
        PeerBlockClient,
        PeerBlockServer,
        PrefixHeat,
        preplace,
    )
    from dynamo_tpu_torch.block_manager.integrity import block_checksum
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.faults import FAULTS

    t_leg = time.monotonic()
    rng = np.random.default_rng(6)
    prompts = []
    for _ in range(KVBM_GROUPS):
        prefix = rng.integers(0, vocab, KVBM_PREFIX).tolist()
        prompts += [prefix + rng.integers(0, vocab, KVBM_SUFFIX).tolist()
                    for _ in range(KVBM_PER_GROUP)]
    fresh = rng.integers(0, vocab, KVBM_PREFIX + KVBM_SUFFIX).tolist()
    firsts = list(range(0, len(prompts), KVBM_PER_GROUP))
    # The adaptive gate would onboard a 4-block probe first: this leg
    # measures the peer tier, so every landed row onboards.
    ecfg = disagg_config(kvbm_adaptive_gate=False)
    layout = KvLayoutConfig.for_engine(ecfg, quant=None)
    bs, L = ecfg.block_size, ecfg.model.num_layers

    def chain(p):
        return TokenBlockSequence.from_tokens(p, block_size=bs).sequence_hashes()[
            : (len(p) - 1) // bs]

    out: dict = {"leg": "g4", "prompts": len(prompts), "block_bytes": layout.block_bytes}
    drts, kvbms, engines, closers = [], [], [], []

    async def worker(name, actuals=None):
        drt = await DistributedRuntime.connect(address)
        kvbm = await KvBlockManager(KvbmConfig(layout=layout, host_blocks=160)).start()
        eng = TorchEngine(ecfg, params=params, device=DEVICE, block_manager=kvbm,
                          on_kv_actual=None if actuals is None else actuals.append)
        drts.append(drt)
        kvbms.append(kvbm)
        engines.append(eng)
        await eng.start()
        out[f"warmup_{name}"] = await warm_up(eng)
        return drt, kvbm, eng

    async def attach(drt, kvbm, want):
        client = await PeerBlockClient(
            drt, drt.namespace("dynamo").component("g4"), layout, layout_cfg=layout).start()
        closers.append(client.stop)
        await until(lambda: all(client.best_peer(h)[1] == len(h) for h in want), 10.0,
                    "g4 blockset discovery")
        kvbm.attach_peer_client(client)
        return client

    async def counted_serve(name, eng, ps):
        """Serve ``ps``; the ragged launches must be num_layers per dispatch,
        with nothing captured mid-traffic."""
        await eng.wait_drained(30)
        d0 = eng.unified_dispatches
        reset_counts()
        streams, fin, ttft, wall = await serve(eng, ps, max_tokens)
        await eng.wait_drained(30)
        dispatches = eng.unified_dispatches - d0
        if fn.launches != L * dispatches or not dispatches or mid_traffic(eng):
            fail(f"disagg g4 {name}: ragged kernel launched {fn.launches} "
                             f"times for {dispatches} dispatches, "
                             f"{mid_traffic(eng)} graphs captured mid-traffic")
        out["ragged_launches"] = out.get("ragged_launches", 0) + fn.launches
        stream_gates(f"g4_{name}", ecfg.model, params, ps, streams, fin, max_tokens)
        return streams, ttft, wall

    def fail(part):
        fail(f"disagg g4 {part}: gates failed {json.dumps(out, default=str)}")

    def parks(eng) -> list:
        """Record each admission's park decision."""
        seen = []
        decide = eng._maybe_park_for_peer_pull

        def counted(seq):
            parked = decide(seq)
            seen.append(parked)
            return parked
        eng._maybe_park_for_peer_pull = counted
        return seen

    try:
        # A: the prompts (and a fresh one) served cold, offered to G2, and
        # exported.
        drt_a, kvbm_a, eng_a = await worker("a")
        cold, cold_ttft, _ = await counted_serve("a_cold", eng_a, prompts + [fresh])
        await kvbm_a.drain_offers()
        server_a = await PeerBlockServer(
            drt_a, drt_a.namespace("dynamo").component("g4"), kvbm_a, layout=layout,
            refresh_s=0.05).start()
        closers.append(server_a.stop)
        crc_a = {h: kvbm_a.host_pool.get_by_hash(h).checksum
                 for h in kvbm_a.host_pool.registered_hashes()}
        await eng_a.stop()
        engines.remove(eng_a)

        # (a) B: cold, a peer client attached; each group's first request
        # parks and pulls, its siblings park on the same transfer.
        actuals_b: list[dict] = []
        drt_b, kvbm_b, eng_b = await worker("b", actuals_b)
        client_b = await attach(drt_b, kvbm_b, [chain(p) for p in prompts])
        wid = client_b.best_peer(chain(prompts[0]))[0]
        n0 = len(chain(prompts[0]))
        priced_pull_s, priced_recompute_s = client_b.price(n0, wid, None)
        parked_b = parks(eng_b)
        streams_b, ttft_b, wall_b = await counted_serve("pull", eng_b, prompts)
        await kvbm_b.drain_pulls(30)
        rd = eng_b.readiness()
        pulled = sorted(h for h in kvbm_b.host_pool.registered_hashes()
                        if kvbm_b.count_peer_origin([h]))
        landed_equal = sum(kvbm_b.host_pool.get_by_hash(h).checksum == crc_a.get(h)
                           for h in pulled)
        ids = [(h, eng_b.allocator._hash_to_block[h]) for h in pulled
               if h in eng_b.allocator._hash_to_block]
        rows = eng_b.runner.gather_many([b for _, b in ids]) if ids else []
        device_equal = sum(block_checksum(r) == crc_a[h] for (h, _), r in zip(ids, rows))
        peer_attributed = sum(a["peer_blocks"] for a in actuals_b)
        bps = rd["kvbm_link_peer_bps"]
        out["pull"] = {
            "parks": sum(parked_b), "ttft_p50_ms": float(np.median(ttft_b)) * 1e3,
            "ttft_first_ms": [ttft_b[i] * 1e3 for i in firsts], "wall_s": wall_b,
            "pulls_total": rd["kvbm_g4_pulls_total"],
            "pull_bytes_total": rd["kvbm_g4_pull_bytes_total"],
            "pull_fallbacks_total": rd["kvbm_g4_pull_fallbacks_total"],
            "reused_peer_blocks_total": rd["kv_reused_peer_blocks_total"],
            "kv_actual_peer_blocks": peer_attributed,
            "pulled_rows": len(pulled), "landed_crc_equal": landed_equal,
            "device_compared": len(ids), "device_crc_equal": device_equal,
            "pull_gbps": bps / 1e9,
            "first_plan": {"blocks": n0, "priced_pull_ms": priced_pull_s * 1e3,
                           "priced_recompute_ms": priced_recompute_s * 1e3,
                           "measured_pull_ms": (n0 * layout.block_bytes / bps * 1e3
                                                if bps else None)},
            "degraded_requests": eng_b.degraded_requests,
        }
        # The same prompts recomputed on B: its caches out of reach.
        eng_b.allocator.clear_reusable()
        eng_b.kvbm = None
        _s, ttft_rc, _w = await counted_serve("recompute", eng_b, prompts)
        eng_b.kvbm = kvbm_b
        out["pull"]["recompute_ttft_p50_ms"] = float(np.median(ttft_rc)) * 1e3
        out["pull"]["recompute_ttft_first_ms"] = [ttft_rc[i] * 1e3 for i in firsts]
        # The law's decision for a fresh prefix once the measured rate is in.
        pull_s, recompute_s = client_b.price(len(chain(fresh)), wid, eng_b._prefill_tps)
        out["pull"]["fresh_plan"] = {
            "decision": "recompute" if client_b.plan(chain(fresh), eng_b._prefill_tps)
            is None else "pull", "pull_ms": pull_s * 1e3, "recompute_ms": recompute_s * 1e3,
            "prefill_tps": eng_b._prefill_tps}
        pa = out["pull"]
        if (not pa["pulls_total"] or pa["pull_fallbacks_total"] or not pulled
                or landed_equal != len(pulled) or not ids or device_equal != len(ids)
                or not peer_attributed or peer_attributed != pa["reused_peer_blocks_total"]
                or pa["degraded_requests"] or not pa["parks"]):
            fail("pull")

        # (b) C: the hottest chains pre-placed before it takes traffic.
        heat = PrefixHeat()
        for p in prompts:
            heat.note(chain(p))
        actuals_c: list[dict] = []
        drt_c, kvbm_c, eng_c = await worker("c", actuals_c)
        client_c = await attach(drt_c, kvbm_c, [chain(p) for p in prompts])
        t0 = time.monotonic()
        landed = await preplace(client_c, kvbm_c, heat)
        preplace_s = time.monotonic() - t0
        # C's first requests: each group's hottest prompt, whose chain the
        # heat kept (one per leading hash).
        parked_c = parks(eng_c)
        _s, ttft_c, _w = await counted_serve("preplaced", eng_c, [prompts[i] for i in firsts])
        out["preplace"] = {
            "landed_blocks": landed, "preplace_s": preplace_s, "parks": sum(parked_c),
            "first_requests": [{k: r[k] for k in ("device_blocks", "host_blocks",
                                                  "peer_blocks", "isl_blocks")}
                               for r in actuals_c],
            "ttft_first_ms": [t * 1e3 for t in ttft_c],
            "pull_gbps": kvbm_c.stats()["link_peer_bps"] / 1e9,
        }
        if (not landed or any(parked_c) or len(actuals_c) != len(firsts) or any(
                r["host_blocks"] + r["peer_blocks"] != len(chain(prompts[i]))
                for r, i in zip(actuals_c, firsts))):
            fail("preplace")
        await eng_c.stop()
        engines.remove(eng_c)

        # (c) A fresh prefix, the pull held in flight, A's runtime shut down.
        # A's exporter restarts (its advertised serve rate back to 0) and B
        # takes a fresh client (no measured rate): the law prices the pull
        # at the calibrated channel and parks. With the rates (a) measured
        # it would recompute instead (``fresh_plan``).
        await server_a.stop()
        server_a = await PeerBlockServer(
            drt_a, drt_a.namespace("dynamo").component("g4"), kvbm_a, layout=layout,
            refresh_s=0.05).start()
        closers.append(server_a.stop)
        client_b2 = await attach(drt_b, kvbm_b, [chain(fresh)])
        degraded0 = eng_b.degraded_requests
        FAULTS.arm("kvbm.peer_pull", "delay", times=None, delay_s=G4_HOLD_S)
        try:
            t0 = time.monotonic()
            task = asyncio.ensure_future(serve(eng_b, [fresh], max_tokens))
            await until(lambda: eng_b._peer_parked or task.done(), 10.0, "g4 park")
            t_park, parked = time.monotonic() - t0, bool(eng_b._peer_parked)
            await drt_a.shutdown()
            drts.remove(drt_a)
            await server_a.stop()  # its refresh loop; the unpublish fails quietly
            limit = ecfg.kvbm_peer_timeout_s + G4_SLACK_S
            streams_f, fin_f, ttft_f, _w = await asyncio.wait_for(task, limit)
            t_done = time.monotonic() - t0
        finally:
            FAULTS.disarm("kvbm.peer_pull")
        await kvbm_b.drain_pulls(30)
        stream_gates("g4_peer_death", ecfg.model, params, [fresh], streams_f, fin_f,
                     max_tokens)
        rd = eng_b.readiness()
        out["peer_death"] = {
            "parked": parked, "parked_after_s": t_park, "completed_s": t_done,
            "limit_s": limit,
            "ttft_ms": ttft_f[0] * 1e3,
            "degraded_delta": eng_b.degraded_requests - degraded0,
            "pull_fallbacks_total": rd["kvbm_g4_pull_fallbacks_total"],
            "client_fallbacks": client_b2.pull_fallbacks_total,
        }
        pd = out["peer_death"]
        if (not parked or t_done > limit or pd["degraded_delta"] != 1
                or pd["pull_fallbacks_total"] < 1):
            fail("peer_death")
    finally:
        FAULTS.disarm("kvbm.peer_pull")
        for e in engines:
            await e.stop()
        for close in reversed(closers):
            with contextlib.suppress(Exception):
                await close()
        for k in kvbms:
            await k.stop()
        for d in drts:
            with contextlib.suppress(Exception):
                await d.shutdown()
    out["wall_s"] = time.monotonic() - t_leg
    return out


async def phase_disagg(vocab: int, max_tokens: int, params) -> dict:
    """Disaggregated prefill/decode at full width (llama3.2-1b), over the
    three transports, an int8 pair, and the KVBM tiers: see the module
    docstring (phase 10)."""
    from dynamo_tpu_torch.disagg import PrefillQueue, PrefillWorker
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer
    from dynamo_tpu_torch.utils.tracing import reset_tracer

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_disagg_")
    trace = os.path.join(tmp, "trace.jsonl")
    result: dict = {"phase": "disagg"}
    server = await ControlPlaneServer(port=0).start()
    front = await DistributedRuntime.connect(server.address)
    # The prefill worker processes start now: their start-up overlaps
    # the in-process legs.
    workers = {
        "bf16": await Child("prefill worker bf16", [
            "--control-plane", server.address, "--namespace", "wire", *WORKER_ARGS],
            module="dynamo_tpu_torch.examples.prefill_worker",
            env={"DYNTPU_TRACE": trace}).start(),
        "int8": await Child("prefill worker int8", [
            "--control-plane", server.address, "--namespace", "wire8", "--kv-quant",
            "int8", *WORKER_ARGS], module="dynamo_tpu_torch.examples.prefill_worker",
            env={"DYNTPU_TRACE": trace}).start(),
    }
    engines = []
    try:
        # device: both engines in this process, the device channel.
        reset_tracer(trace)
        decode = TorchEngine(disagg_config(), device=DEVICE)
        prefill = TorchEngine(disagg_config(), device=DEVICE)
        engines += [decode, prefill]
        for e in (decode, prefill):
            await e.start()
            await warm_up(e)
        dev_params = decode.runner.params
        prompts = disagg_prompts(1, vocab)
        # The same prompts served locally on the decode engine first: the
        # TTFT the remote path is compared with.
        local_streams, _f, local_ttft, _w = await serve(decode, prompts, max_tokens)
        await decode.wait_drained(30)
        decode.allocator.clear_reusable()
        drt = await DistributedRuntime.in_process()
        queue = PrefillQueue(drt, "device")
        pw = PrefillWorker(prefill, queue).start()
        try:
            leg = await disagg_leg("device", decode, queue, "device", prompts, max_tokens,
                                   dev_params, prefill=prefill)
        finally:
            await pw.stop()
            await drt.shutdown()
        leg["ttft_same_prompts_local_p50_ms"] = float(np.median(local_ttft[:4])) * 1e3
        leg["match_rate_vs_local"] = match_rate(leg.pop("streams"), local_streams)
        leg["sender_vs_receiver_blocks"] = device_crc_match(prefill, decode, prompts[:4])
        c = leg["sender_vs_receiver_blocks"]
        if not c["blocks_compared"] or c["blocks_crc_equal"] != c["blocks_compared"]:
            fail(f"disagg device: received blocks differ from sent {c}")
        result["device"] = leg
        emit({"phase": "disagg_leg", **leg})
        for e in (decode, prefill):
            await e.stop()
        engines.clear()
        del decode, prefill
        gc.collect()
        torch.cuda.empty_cache()

        # kvbm: one engine over the G2 host and G3 disk tiers.
        result["kvbm"] = await kvbm_leg(vocab, max_tokens, params)
        emit({"phase": "disagg_leg", **result["kvbm"]})
        gc.collect()
        torch.cuda.empty_cache()

        # g4: three engines pooling KV through their peers.
        result["g4"] = await g4_leg(vocab, max_tokens, params, server.address)
        emit({"phase": "disagg_leg", **result["g4"]})
        gc.collect()
        torch.cuda.empty_cache()

        # tcp and native: the prefill engine in a worker process.
        decode = TorchEngine(disagg_config(), device=DEVICE)
        engines.append(decode)
        await decode.start()
        await warm_up(decode)
        await workers["bf16"].wait_for(r"READY \d+", FLEET_WAIT_S)
        served = 0
        for seed, transport in ((2, "tcp"), (3, "native")):
            leg = await disagg_leg(transport, decode, PrefillQueue(front, "wire"), transport,
                                   disagg_prompts(seed, vocab), max_tokens, params)
            leg.pop("streams")
            served += 4
            result[transport] = leg
            emit({"phase": "disagg_leg", **leg})
        result["worker_bf16"] = await worker_done(workers["bf16"], "bf16", served)
        await decode.stop()
        engines.clear()
        del decode
        gc.collect()
        torch.cuda.empty_cache()

        # int8: an int8-KV pair over tcp (packed rows with their scales).
        decode = TorchEngine(disagg_config(kv_quant="int8"), device=DEVICE)
        engines.append(decode)
        await decode.start()
        await warm_up(decode)
        await workers["int8"].wait_for(r"READY \d+", FLEET_WAIT_S)
        leg = await disagg_leg("int8", decode, PrefillQueue(front, "wire8"), "tcp",
                               disagg_prompts(4, vocab), max_tokens, params)
        leg.pop("streams")
        lay = decode.runner._quant_layout()
        if leg["bytes_received"]["tcp"] != leg["expected_blocks"] * lay.block_bytes:
            fail(f"disagg int8: {leg['bytes_received']} bytes for "
                             f"{leg['expected_blocks']} packed rows of {lay.block_bytes}")
        result["int8"] = leg
        emit({"phase": "disagg_leg", **leg})
        result["worker_int8"] = await worker_done(workers["int8"], "int8", 4)
    finally:
        for e in engines:
            await e.stop()
        for w in workers.values():
            await w.kill()
        reset_tracer(None)
        await front.shutdown()
        await server.stop()
    # kv_transfer spans: the device leg's in this process's capture, the
    # wire legs' in each worker's (tcp then native in the bf16 worker's).
    per_leg = {"device": span_ms(trace, "kv_transfer")}
    bf16 = span_ms(f"{trace}.{workers['bf16'].proc.pid}", "kv_transfer")
    per_leg["tcp"], per_leg["native"] = bf16[:4], bf16[4:]
    per_leg["int8"] = span_ms(f"{trace}.{workers['int8'].proc.pid}", "kv_transfer")
    for name, s in per_leg.items():
        leg = result[name]
        leg["kv_transfer_spans"] = len(s)
        leg["kv_transfer_p50_ms"] = pct(s, 50)
        leg["kv_transfer_p95_ms"] = pct(s, 95)
        moved = sum(leg["bytes_received"].values())
        leg["kv_transfer_gbps"] = moved / (sum(s) / 1e3) / 1e9 if s else None
    shutil.rmtree(tmp, ignore_errors=True)
    if [len(s) for s in per_leg.values()] != [4, 4, 4, 4]:
        fail(f"disagg: kv_transfer spans per leg "
                         f"{ {k: len(v) for k, v in per_leg.items()} }")
    result["wall_s"] = time.monotonic() - t_phase
    emit({"phase": "disagg", **{k: v for k, v in result.items()
                                if k not in ("device", "tcp", "native", "int8", "kvbm", "g4")},
          "summary": {n: {k: result[n].get(k) for k in (
              "ttft_remote_p50_ms", "ttft_local_p50_ms", "ttft_same_prompts_local_p50_ms",
              "kv_transfer_p50_ms", "kv_transfer_p95_ms", "kv_transfer_gbps",
              "unified_dispatches", "kernel_launches")}
              for n in ("device", "tcp", "native", "int8")}})
    return result


# -- phase 11: the planner ------------------------------------------------------
# The calibration engine: 64 slots, a 2048-token budget, prompts admitted
# 15 at a time (15 × 128 prompt tokens and up to 64 decode lanes fit the
# budget, so no prompt splits across dispatches: the fused-batch policy
# the simulator models).
CAL_ENGINE = {"max_num_seqs": 64, "unified_token_budget": 2048,
              "unified_prefill_quantum": 2048, "prefill_batch": 15,
              "max_model_len": 2304, "num_blocks": 2048, "warmup_gate": "hold"}
CAL_LANES = (32, 64)          # decode dispatches of this many lanes ...
CAL_CONTEXT = 160             # ... each over this many tokens of context
CAL_PREFILL = (128, 512, 2048)    # prefill-only dispatches of prompts this long
CAL_HEADLINE = (64, 128, 64)  # requests (all at once), prompt and output tokens
CAL_REPS = 20                 # dispatches per timed point
PLANNER_TICK = 0.25           # the planner's --metric-interval, s
PLANNER_ADJUST = 2.0          # its --adjustment-interval, s
PLANNER_CLIENTS = 24          # the aggregated leg's closed-loop clients
PLANNER_TOKENS = 64           # greedy tokens per request of the planner legs
POOL_CLIENTS = 8              # the two-pool leg's closed-loop remote requests


def cal_record_path() -> str:
    """Where the calibration leg writes its record (beside this script)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_out",
                        "calibration_h100.json")


def param_bytes(params) -> int:
    """Bytes of every weight tensor (what a decode dispatch streams)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_bytes(v) for v in params)
    return 0


async def calibration_leg(card: str, vocab: int) -> dict:
    """The H100 calibration record (planner/calibration.py's artifact):
    decode dispatches at CAL_LANES lanes, the engine's full prefill-only
    dispatches of prompts of CAL_PREFILL tokens (a standalone runner,
    graphs replayed, device ms from the profiler), pinned copies of 1
    and 64 KV blocks, and the
    headline serve (CAL_HEADLINE, all at once) through an engine with
    the same settings: tok/s and TTFT p50, then again under the profiler
    for the device ms per dispatch beside the wall per dispatch."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.planner import calibration as cal
    from torch.profiler import ProfilerActivity, profile

    ecfg = full_width_config(**CAL_ENGINE)
    t_leg = time.monotonic()
    runner = ModelRunner(ecfg, device=DEVICE)
    graphs = runner.warmup()
    greedy = (0.0, 0, 1.0, -1)

    def timed(lanes) -> float:
        for _ in range(3):
            runner.unified_step(lanes).tokens()
        return profiled_device_ms(
            lambda: [runner.unified_step(lanes) for _ in range(CAL_REPS)]) / CAL_REPS

    nb = (CAL_CONTEXT + BS) // BS         # blocks of a lane's context + its token
    decode_ms = []
    for n in CAL_LANES:
        lanes = [([7], list(range(1 + i * nb, 1 + (i + 1) * nb)), CAL_CONTEXT, greedy)
                 for i in range(n)]
        decode_ms.append(timed(lanes))
    # Each the engine's full prefill dispatch of its prompt length: as
    # many prompts as it admits at once and its budget holds.
    prefill_ms, prefill_prompts = [], []
    for n in CAL_PREFILL:
        rng = np.random.default_rng(n)
        k = min(ecfg.prefill_batch, ecfg.unified_token_budget // n)
        nb = (n + BS - 1) // BS
        lanes = [(rng.integers(0, vocab, n).tolist(),
                  list(range(1 + i * nb, 1 + (i + 1) * nb)), 0, greedy) for i in range(k)]
        prefill_prompts.append(k)
        prefill_ms.append(timed(lanes))
    weights = param_bytes(runner.params)
    params = runner.params
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    handoff_ms = [h2d_kv_rate(n, 50)["ms"] for n in (1, 64)]

    reqs, isl, osl = CAL_HEADLINE
    rng = np.random.default_rng([11, 1])
    heads = [rng.integers(0, vocab, isl).tolist() for _ in range(reqs)]
    prof_prompts = [rng.integers(0, vocab, isl).tolist() for _ in range(reqs)]
    engine = TorchEngine(ecfg, params=params, device=DEVICE)
    await engine.start()
    try:
        # All at once: the requests wait at the warmup gate and are
        # released together, the first dispatch composing all of them;
        # times run from that dispatch's start on the engine thread (its
        # flight record), not from the submissions.
        warm = asyncio.ensure_future(engine.warmup())
        # The first dispatches' lanes, kept by reference (no copy on the
        # timed path): the prefill phase replays them below.
        step, lanes_of = engine.runner.unified_step, []

        def keep(lanes, **kw):
            if len(lanes_of) < 16:
                lanes_of.append(lanes)
            return step(lanes, **kw)

        engine.runner.unified_step = keep
        held = asyncio.ensure_future(serve_unix(engine, heads, osl))
        await warm
        streams, firsts, lasts = await held
        del engine.runner.unified_step
        steps = [r for r in engine.flight.snapshot() if r.get("kind") == "unified"]
        t0 = steps[0]["t_unix"] - steps[0]["dispatch_ms"] / 1e3
        ttft = [t - t0 for t in firsts]
        wall = max(lasts) - t0
        dispatches = len(steps)
        first_steps = [(r["prefill_tokens"], r["decode_tokens"]) for r in steps[:6]]
        # The prefill phase: its dispatches replayed one at a time on the
        # idle engine's runner for their device time, beside its wall (to
        # the last first token).
        n_pre = sum(1 for r in steps if r["prefill_tokens"])
        pre_device_ms = sum(
            profiled_device_ms(lambda lanes=lanes: engine.runner.unified_step(lanes))
            for lanes in lanes_of[:n_pre])
        d1 = engine.unified_dispatches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            *_, prof_wall = await serve(engine, prof_prompts, osl)
            torch.cuda.synchronize()
        prof_dispatches = engine.unified_dispatches - d1
        busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
        mid = mid_traffic(engine)
    finally:
        await engine.stop()
    if not all(len(s) == osl for s in streams) or mid:
        fail(f"planner calibration: headline streams {[len(s) for s in streams]}, "
                         f"{mid} captures mid-traffic")
    record = {
        "schema": cal.SCHEMA, "card": card, "model": ecfg.model.name, "dtype": ecfg.dtype,
        "source": "chip_smoke.py phase 11 (planner), calibration leg",
        "engine": {**CAL_ENGINE, "block_size": ecfg.block_size, "graphs": graphs},
        "decode": {"lanes": list(CAL_LANES), "context_tokens": CAL_CONTEXT,
                   "device_ms": decode_ms, "weight_bytes": weights,
                   "streamed_bytes": weights + CAL_LANES[-1] * (CAL_CONTEXT + 1)
                   * cal.KV_BYTES_PER_TOKEN},
        "prefill": {"tokens": list(CAL_PREFILL), "prompts": prefill_prompts,
                    "device_ms": prefill_ms},
        "host": {"wall_ms_per_dispatch": wall * 1e3 / dispatches,
                 "device_ms_per_dispatch": busy / prof_dispatches,
                 "dispatches": dispatches, "profiled_dispatches": prof_dispatches,
                 "profiled_wall_ms_per_dispatch": prof_wall * 1e3 / prof_dispatches,
                 "prefill_wall_ms": max(ttft) * 1e3, "prefill_device_ms": pre_device_ms,
                 "prefill_dispatches": n_pre},
        "handoff": {"blocks": [1, 64], "block_bytes": KV_BLOCK_BYTES, "ms": handoff_ms},
        "headline": {"num_requests": reqs, "isl": isl, "osl": osl,
                     "tok_s": reqs * osl / wall, "p50_ttft_ms": float(np.median(ttft)) * 1e3,
                     "wall_s": wall, "dispatches": dispatches,
                     "first_dispatches_prefill_decode": first_steps},
    }
    fresh = cal.derive(record)   # raises unless every term is finite and positive
    from dynamo_tpu_torch.planner.simulate import calibrated_headline

    sim = calibrated_headline(fresh)
    os.makedirs(os.path.dirname(cal_record_path()), exist_ok=True)
    with open(cal_record_path(), "w") as f:
        json.dump(record, f, indent=1)
    emit({"phase": "calibration_record", **record})
    try:
        committed = cal.CALIBRATION.price_list()
        drift = {k: (v - committed[k]) / committed[k] if committed[k] else None
                 for k, v in fresh.price_list().items()}
    except ValueError as exc:   # reported, not gated: a record of an older layout
        drift = {"unavailable": str(exc)}
    out = {"leg": "calibration", "record": cal_record_path(), "fit": fresh.price_list(),
           "prefill_quadratic_free_us": fresh.prefill_quadratic_free_us,
           "drift_vs_committed": drift,
           "sim_headline": {"tok_s": sim.tok_s, "p50_ttft_ms": sim.p50_ttft_ms,
                            "tok_s_error": sim.tok_s / record["headline"]["tok_s"] - 1,
                            "p50_ttft_error": sim.p50_ttft_ms
                            / record["headline"]["p50_ttft_ms"] - 1},
           "wall_s": time.monotonic() - t_leg}
    emit({"phase": "planner_leg", **out, "headline": record["headline"],
          "host": record["host"]})
    return out


async def serve_unix(engine, prompts, max_tokens):
    """``serve`` with wall-clock times: (streams, each request's first
    and last token time, unix seconds)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        EngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(p):
        pre = PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=max_tokens, ignore_eos=True))
        toks, first, last = [], None, None
        async for raw in engine.generate(Context(pre.to_wire())):
            out = EngineOutput.from_wire(raw)
            if out.token_ids:
                last = time.time()
                first = first or last
            toks.extend(out.token_ids)
        return toks, first, last

    results = await asyncio.gather(*[one(p) for p in prompts])
    return [r[0] for r in results], [r[1] for r in results], [r[2] for r in results]


class LogFile:
    """The output of one process the planner spawned (its worker command
    redirects it to a file of its own), matched line by line."""

    def __init__(self, path: str, name: str) -> None:
        self.path, self.name = path, name

    def lines(self) -> list[str]:
        try:
            with open(self.path, errors="replace") as f:
                return f.read().splitlines()
        except FileNotFoundError:
            return []

    def tail(self, n: int = 30) -> str:
        return "\n".join(self.lines()[-n:])

    async def wait_for(self, pattern: str, timeout: float):
        """(match, time seen) of the first line matching ``pattern``."""
        import re

        pat = re.compile(pattern)
        deadline = time.monotonic() + timeout
        while True:
            for line in self.lines():
                m = pat.search(line)
                if m:
                    return m, time.monotonic()
            if time.monotonic() > deadline:
                fail(f"planner: {self.name} gave no {pattern!r} in "
                                 f"{timeout:.0f} s:\n{self.tail()}")
            await asyncio.sleep(0.05)


def decisions(path: str) -> list[dict]:
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except FileNotFoundError:
        return []


def state_pids(path: str, pool: str | None = None) -> list[int]:
    """Worker pids of a planner state file (v1, or one pool of v2)."""
    try:
        with open(path) as f:
            st = json.load(f)
    except (FileNotFoundError, ValueError):
        return []
    workers = st["pools"][pool]["workers"] if pool else st.get("workers", [])
    return [w["pid"] for w in workers]


def pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def worker_cmd(tmp: str, tag: str, argv: list[str]) -> str:
    """A planner ``--worker-cmd``: one process per ``{index}``, its
    output in a file of its own (``exec``: the pid the planner holds is
    the worker's, so SIGTERM reaches it and it drains)."""
    import shlex

    log = os.path.join(tmp, f"{tag}-{{index}}.log")
    return f"exec {shlex.quote(sys.executable)} {' '.join(shlex.quote(a) for a in argv)} > {log} 2>&1"


class ClosedLoop:
    """``clients`` concurrent requests: each client sends its next one
    when its last ends, drawing prompts in turn, until ``stop()``.
    Every result is kept with its send and first-token times. A request
    that raises (a failed gate too: a SystemExit escaping a task would
    stop the event loop) is printed at once and fails ``stop()``."""

    def __init__(self, send, prompts, clients: int) -> None:
        self.send, self.prompts, self.clients = send, prompts, clients
        self.results: list[dict] = []
        self.errors: list[str] = []
        self._stop = asyncio.Event()
        self._n = 0
        self._tasks: list = []

    async def _client(self) -> None:
        while not self._stop.is_set():
            i = self._n
            self._n += 1
            try:
                self.results.append(await self.send(i, self.prompts[i % len(self.prompts)]))
            except (Exception, GateFailed) as exc:
                self.errors.append(f"request {i}: {type(exc).__name__}: {exc}"[:2000])
                print(f"closed loop: {self.errors[-1]}", file=sys.stderr, flush=True)
                return

    def start(self) -> "ClosedLoop":
        self._tasks = [asyncio.ensure_future(self._client()) for _ in range(self.clients)]
        return self

    async def stop(self) -> list[dict]:
        self._stop.set()
        await asyncio.gather(*self._tasks)
        if self.errors:
            fail(f"closed loop: {len(self.errors)} request(s) raised", self.errors[:4])
        return self.results

    async def cancel(self) -> None:
        """End every client now (a leg that failed before ``stop()``)."""
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)



async def wait_decision(path: str, pool: str | None, decision: str, after: float,
                        timeout: float) -> dict:
    """The first decision-log line of ``pool`` (None: the single-pool
    log) taking ``decision`` at or after unix time ``after``."""
    t0 = time.monotonic()
    while True:
        for d in decisions(path):
            if (d["decision"] == decision and d.get("ts", d.get("unix", 0)) >= after
                    and (pool is None or d.get("pool") == pool)):
                return d
        if time.monotonic() - t0 > timeout:
            fail(f"planner: no {decision!r} decision ({pool}) in {timeout:.0f} s: "
                             f"{decisions(path)[-6:]}")
        await asyncio.sleep(0.05)


async def report_of(log: LogFile, timeout: float = 120.0) -> dict:
    m, _ = await log.wait_for(r"worker report (\{.*\})", timeout)
    return json.loads(m.group(1))


async def retire(pid: int, log: LogFile) -> dict:
    """SIGTERM a worker the planner left running; its report."""
    import signal

    os.kill(pid, signal.SIGTERM)
    rep = await report_of(log)
    t0 = time.monotonic()
    while pid_alive(pid):
        if time.monotonic() - t0 > 60:
            fail(f"planner: pid {pid} did not exit after its report")
        await asyncio.sleep(0.05)
    return rep


def dump_logs(leg: str, children=(), logs=(), n: int = 25) -> None:
    """On a failed leg, on stderr: each process's last ``n`` lines and,
    before them, its lines that name an error, a lease, a death or a
    slow callback."""
    import re

    keep = re.compile(r"error|traceback|lease|took \d|stall|died|dead|warn", re.I)
    outputs = [(c.name, [t for _, t in c.lines]) for c in children if c is not None]
    outputs += [(log.name, log.lines()) for log in logs]
    for name, lines in outputs:
        lines = [line.rstrip("\n") for line in lines]
        flagged = [line for line in lines[:-n] if keep.search(line)][-n:]
        print(f"--- {leg}: {name}, {len(lines)} lines; flagged:", *flagged,
              "--- its tail:", *lines[-n:], sep="\n", file=sys.stderr, flush=True)


def agg_logs(tmp: str) -> list:
    """The aggregated leg's worker logs, in spawn order."""
    import re

    names = [n for n in os.listdir(tmp) if re.fullmatch(r"agg-\d+\.log", n)]
    names.sort(key=lambda n: int(n[4:-4]))
    return [LogFile(os.path.join(tmp, n), f"aggregated worker {n[4:-4]}") for n in names]


async def joined_worker(tmp: str, state: str, obs, lease1: int, deadline: float):
    """(pid, lease, log) of the worker the planner added, once the store
    holds its lease beside ``lease1`` and the state file its pid."""
    import re

    while True:
        pids = state_pids(state)
        if len(pids) == 2:
            leases = await instance_leases(obs)
            for log in agg_logs(tmp)[1:]:
                m = next(filter(None, (re.search(r"\(lease (0x[0-9a-f]+)\)", line)
                                       for line in log.lines())), None)
                if m and leases == {lease1, int(m.group(1), 16)}:
                    return pids[-1], int(m.group(1), 16), log
        if time.monotonic() > deadline:
            fail(f"planner: no second worker joined: pids {pids}, "
                 f"instances {await instance_leases(obs)}")
        await asyncio.sleep(0.05)


async def until_or(cond, gone, deadline: float, what: str) -> bool:
    """True once ``cond()`` holds; False if ``gone()`` does first."""
    while not cond():
        if gone():
            return False
        if time.monotonic() > deadline:
            fail(f"planner: timed out waiting for {what}")
        await asyncio.sleep(0.01)
    return True


def unique_prompt(base: list[int], i: int, vocab: int) -> list[int]:
    """``base`` with its first token set from ``i``: each request of a
    closed loop has a prompt of its own (the Tap keys streams by it)."""
    return [(1 + i * 7919) % vocab] + base[1:]


async def aggregated_leg(tmp: str, cfg, params, vocab: int) -> dict:
    """The single-pool planner (watermark law) over real workers: see
    the module docstring (phase 11, aggregated)."""
    import signal

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.pipeline import Tap

    tapped: dict[tuple, dict] = {}

    def on_request(ctx):
        tapped[tuple(ctx.payload["token_ids"])] = {"tokens": [], "workers": [], "first": None}

    def on_response(ctx, item):
        rec = tapped[tuple(ctx.payload["token_ids"])]
        wid = ctx.annotations.get("worker_id")
        if not rec["workers"] or rec["workers"][-1] != wid:
            rec["workers"].append(wid)
        if rec["first"] is None and item["token_ids"]:
            rec["first"] = time.time()
        rec["tokens"].extend(item["token_ids"])

    rng = np.random.default_rng(1)
    bases = [rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(64, 513, 24)]
    greedy = {"temperature": 0, "nvext": {"ignore_eos": True}}
    state = os.path.join(tmp, "agg-state.json")
    dlog = os.path.join(tmp, "agg-decisions.jsonl")
    log1 = LogFile(os.path.join(tmp, "agg-1.log"), "aggregated worker 1")
    children: list = []
    result: dict = {"leg": "aggregated"}
    obs = None
    pids: list[int] = []
    t_leg = time.monotonic()
    try:
        cp = Child("planner control plane", ["control-plane", "--host", "127.0.0.1",
                                             "--port", "0"])
        children.append(cp)
        await cp.start()
        addr = (await cp.wait_for(r"control plane on (\S+)", 120))[0].group(1)
        obs = await DistributedRuntime.connect(addr)
        cmd = worker_cmd(tmp, "agg", ["-m", "dynamo_tpu_torch", *HTTP_ARGS, "--in",
                                      FLEET_ENDPOINT, "--control-plane", addr])
        async with contextlib.AsyncExitStack() as stack:
            args = cli.build_parser().parse_args([
                "run", "--in", "http", "--out", "dyn", "--control-plane", addr,
                "--http-host", "127.0.0.1", "--http-port", "0"])
            cli.refuse_unserved(args)
            service, _ = await cli.start_http(args, stack,
                                              engine_ops=(Tap(on_request, on_response),))
            port = service.port
            planner = Child("planner", [
                "planner", "--control-plane", addr, "--min-workers", "1",
                "--max-workers", "2", "--metric-interval", str(PLANNER_TICK),
                "--adjustment-interval", str(PLANNER_ADJUST), "--state-path", state,
                "--decision-log", dlog, "--worker-cmd", cmd])
            children.append(planner)
            await planner.start()
            await planner.wait_for(r"^planner running", 60)
            lease1 = int((await log1.wait_for(r"\(lease (0x[0-9a-f]+)\)", FLEET_WAIT_S))[0]
                         .group(1), 16)
            await log1.wait_for(r"worker serving ", FLEET_WAIT_S)
            await wait_leases(obs, {lease1})
            await wait_model(port, cfg.name)
            result["worker_1_ready_s"] = time.monotonic() - t_leg

            async def send(i, base):
                p = unique_prompt(base, i, vocab)
                t_send = time.time()
                resp, timed = await http_stream(port, "/v1/completions", {
                    "model": cfg.name, "prompt": p, "stream": True,
                    "max_tokens": PLANNER_TOKENS, **greedy})
                s = stream_summary(timed)
                return {"prompt": p, "status": resp.status, "finish": s["finish"],
                        "tokens": (s["usage"] or {}).get("completion_tokens"),
                        "events": len(s["times"]), "t_send": t_send,
                        "ttft_ms": s["times"][0] * 1e3 if s["times"] else None}

            t_load = time.time()
            load = ClosedLoop(send, bases, PLANNER_CLIENTS).start()
            # Runs before the HTTP service stops (the stack unwinds in
            # reverse), so a failed leg leaves no stream to break.
            stack.push_async_callback(load.cancel)
            first_up = await wait_decision(dlog, None, "up", t_load, 60)
            # The worker the planner added, followed until it has served
            # and two more rounds of the clients ran on two workers (the
            # TTFT after). The watermark law reads only the workers'
            # queues, and they can run dry while a new worker starts
            # (PERF.md §6): a scale-down under load then retires it
            # and a later scale-up adds another. Each such retirement is
            # counted and reported; the gates hold for the one that stays.
            deadline = time.monotonic() + FLEET_WAIT_S + 240
            retired: list[int] = []
            while True:
                pid2, lease2, log2 = await joined_worker(tmp, state, obs, lease1, deadline)
                t_lease = time.time()

                def served_by_2():
                    return [r for r in tapped.values()
                            if lease2 in r["workers"] and r["first"]]

                def left():
                    return pid2 not in state_pids(state)

                if not await until_or(lambda: len(served_by_2()) >= 1, left, deadline,
                                      "the second worker's streams"):
                    retired.append(pid2)
                    continue
                t_first2 = min(r["first"] for r in served_by_2())
                n_first2 = len(load.results)
                if not await until_or(
                        lambda: len(load.results) >= n_first2 + 2 * PLANNER_CLIENTS, left,
                        deadline, "requests after the second worker joined"):
                    retired.append(pid2)
                    continue
                break
            up = [d for d in decisions(dlog) if d["decision"] == "up"
                  and d["ts"] <= t_lease][-1]
            # The load stops when the clients stop sending: a scale-down
            # while the last streams finish counts as after it.
            t_stop = time.time()
            results = await load.stop()
            down = await wait_decision(dlog, None, "down", t_stop, 5 * PLANNER_ADJUST + 10)
            report2 = await report_of(log2)
            await log2.wait_for(r"^drain complete", 5)
            m, _ = await planner.wait_for(rf"worker pid {pid2} exited \(code (\S+)\)", 60)
            rc2 = m.group(1)
            await wait_leases(obs, {lease1})
            planner.signal(signal.SIGTERM)
            planner_rc = await planner.exit_code(60)
            pids = state_pids(state)
            adopted_alive = [pid_alive(p) for p in pids]
            report1 = await retire(pids[0], log1) if pids else {}
            pids = []
        ttft_before = [r["ttft_ms"] for r in results if r["t_send"] < first_up["ts"]
                       and r["ttft_ms"] is not None]
        ttft_after = [r["ttft_ms"] for r in results if r["t_send"] >= t_first2
                      and r["ttft_ms"] is not None]
        bad = [{k: r[k] for k in ("status", "tokens", "events", "finish", "ttft_ms")}
               for r in results if not (r["status"] == 200 and r["tokens"] == PLANNER_TOKENS
                                        and r["events"] == PLANNER_TOKENS
                                        and r["finish"] == "length")]
        full = not bad
        streams = [tapped[tuple(r["prompt"])]["tokens"] for r in results]
        ref = teacher_forced(cfg, params, [r["prompt"] for r in results], streams)
        ref.pop("first_token_ref_logprob")
        dec = decisions(dlog)
        result.update({
            "requests": len(results), "clients": PLANNER_CLIENTS,
            "max_tokens": PLANNER_TOKENS, "streams_full_length": full, "bad_streams": bad[:4],
            "leases": [f"{lease1:#x}", f"{lease2:#x}"],
            "requests_by_worker": {f"{w:#x}": sum(1 for r in results if tapped[tuple(
                r["prompt"])]["workers"] == [w]) for w in (lease1, lease2)},
            "decision_up": up, "decision_down": down, "first_decision_up": first_up,
            "decisions": [d["decision"] for d in dec],
            "retired_under_load": len(retired),
            "up_to_lease_s": t_lease - up["ts"],
            "up_to_new_worker_first_token_s": t_first2 - up["ts"],
            "load_stop_to_down_s": down["ts"] - t_stop,
            "ttft_p50_before_up_ms": pct(ttft_before, 50),
            "ttft_p50_after_new_worker_ms": pct(ttft_after, 50),
            "planner_exit_code": planner_rc, "drained_worker_exit_code": rc2,
            "state_pids_after_sigterm": len(adopted_alive),
            "adopted_worker_alive_after_sigterm": all(adopted_alive) and bool(adopted_alive),
            "worker_reports": {"1": report1, "2": report2},
            "launches_ok": {"1": launches_ok(report1, walk_path=False),
                            "2": launches_ok(report2, walk_path=False)},
            "wall_s": time.monotonic() - t_leg, **ref,
        })
        if not (full and ref["logits_finite"] and ref["logits_shape_ok"]
                and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
                and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
            fail(f"planner aggregated: streams failed their gates {result}")
        if not (down["ts"] - t_stop <= 5 * PLANNER_ADJUST and report2["requests"] >= 1
                and rc2 == "0"
                and all(result["launches_ok"].values()) and planner_rc == 0
                and result["adopted_worker_alive_after_sigterm"]
                and len(adopted_alive) == 1):
            fail(f"planner aggregated: {result}")
    except BaseException:
        dump_logs("planner aggregated", children, agg_logs(tmp))
        raise
    finally:
        import signal as _signal

        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, _signal.SIGKILL)
        # The observer revokes its lease while the plane still runs: killed
        # first, the plane resets the connection under the revoke.
        if obs is not None:
            await obs.shutdown()
        for child in reversed(children):
            await child.kill()
    return result


async def two_pool_leg(tmp: str, cfg, params, vocab: int) -> dict:
    """The two-pool planner: prefill workers it spawns drain the queue a
    decode engine in this process fills; a decode pool held at one; the
    decode pool's worker killed mid-leg: see the module docstring (phase
    11, crash heal and two-pool)."""
    import signal

    from dynamo_tpu_torch.block_manager.integrity import INTEGRITY
    from dynamo_tpu_torch.disagg import DecodeOperator, DisaggConfig, DisaggRouter, PrefillQueue
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import (
        EngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer

    ns = "pool"
    max_tokens = 32
    state = os.path.join(tmp, "pool-state.json")
    dlog = os.path.join(tmp, "pool-decisions.jsonl")
    plogs = [LogFile(os.path.join(tmp, f"prefill-{i}.log"), f"prefill worker {i}")
             for i in (1, 2)]
    dlogs = [LogFile(os.path.join(tmp, f"decode-{i}.log"), f"decode worker {i}")
             for i in (1, 2)]
    result: dict = {"leg": "two_pool"}
    t_leg = time.monotonic()
    server = await ControlPlaneServer(port=0).start()
    front = await DistributedRuntime.connect(server.address)
    planner = None
    decode = None
    op = None
    loads: list = []
    pids: list[int] = []
    try:
        pcmd = worker_cmd(tmp, "prefill", [
            "-m", "dynamo_tpu_torch.examples.prefill_worker", "--control-plane",
            server.address, "--namespace", ns, *WORKER_ARGS])
        dcmd = worker_cmd(tmp, "decode", [
            "-m", "dynamo_tpu_torch", *HTTP_ARGS, "--in", f"dyn://{ns}.decode.generate",
            "--control-plane", server.address])
        planner = await Child("fleet planner", [
            "planner", "--control-plane", server.address, "--namespace", ns, "--two-pool",
            "--worker-cmd", dcmd, "--prefill-worker-cmd", pcmd, "--min-workers", "1",
            "--max-workers", "1", "--prefill-min-workers", "1", "--prefill-max-workers", "2",
            "--decode-component", "decode", "--metric-interval", str(PLANNER_TICK),
            "--adjustment-interval", str(PLANNER_ADJUST), "--state-path", state,
            "--decision-log", dlog]).start()
        await planner.wait_for(r"fleet planner running", 60)
        decode = TorchEngine(disagg_config(), device=DEVICE)
        await decode.start()
        await warm_up(decode)
        await plogs[0].wait_for(r"READY \d+", FLEET_WAIT_S)
        await dlogs[0].wait_for(r"worker serving ", FLEET_WAIT_S)
        result["pools_ready_s"] = time.monotonic() - t_leg
        router = DisaggRouter.__new__(DisaggRouter)
        router.cfg = DisaggConfig(max_local_prefill_length=DISAGG_LOCAL_MAX,
                                  max_prefill_queue_size=64)
        op = await DecodeOperator(decode, PrefillQueue(front, ns), router,
                                  transport="tcp").start()
        INTEGRITY.reset()
        bases = disagg_prompts(5, vocab)[:4] + disagg_prompts(6, vocab)[:4]

        async def send(i, base):
            p = unique_prompt(base, i, vocab)
            pre = PreprocessedRequest(
                token_ids=p, sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=max_tokens, ignore_eos=True))
            t0 = time.monotonic()
            toks, finish, first = [], None, None
            async for raw in op.generate(Context(pre.to_wire())):
                out = EngineOutput.from_wire(raw)
                if out.token_ids and first is None:
                    first = time.monotonic() - t0
                toks.extend(out.token_ids)
                finish = out.finish_reason or finish
            return {"prompt": p, "tokens": toks, "finish": finish, "ttft_ms": first * 1e3}

        t_load = time.time()
        load = ClosedLoop(send, bases, POOL_CLIENTS).start()
        loads.append(load)
        # Crash heal: the decode pool's worker killed, shell and child.
        victim = state_pids(state, "decode")[0]
        seen_before = len(planner.lines)
        t_kill = time.monotonic()
        os.killpg(victim, signal.SIGKILL)
        m, t_seen = await planner.wait_for(
            rf"worker {victim} died .*crash path, no drain", 30)
        gap_s = t_seen - t_kill

        await until(lambda: state_pids(state, "decode") not in ([], [victim]), 30,
                    "the replacement's pid in the state file")
        respawn_s = time.monotonic() - t_kill
        up = await wait_decision(dlog, "prefill", "up", t_load, 60)
        await plogs[1].wait_for(r"READY \d+", FLEET_WAIT_S)
        t_ready2 = time.time()
        p2_pid = state_pids(state, "prefill")[-1]
        n_ready = len(load.results)
        await until(lambda: len(load.results) >= n_ready + 2 * POOL_CLIENTS, 120,
                    "requests after the second prefill worker joined")
        results = await load.stop()
        t_stop = time.time()
        _, t_serving = await dlogs[1].wait_for(r"worker serving ", FLEET_WAIT_S)
        down = await wait_decision(dlog, "prefill", "down", t_stop, 10 * PLANNER_ADJUST + 10)
        report_p2 = await report_of(plogs[1])
        m, _ = await planner.wait_for(rf"worker pid {p2_pid} exited \(code (\S+)\)", 60)
        rc_p2 = m.group(1)
        dec = decisions(dlog)
        decode_decisions = [(d["decision"], d["size"]) for d in dec if d["pool"] == "decode"]
        planner.signal(signal.SIGTERM)
        planner_rc = await planner.exit_code(60)
        pids = state_pids(state, "prefill") + state_pids(state, "decode")
        report_p1 = await retire(state_pids(state, "prefill")[0], plogs[0])
        report_d2 = await retire(state_pids(state, "decode")[0], dlogs[1])
        pids = []
        integrity = INTEGRITY.snapshot()
        remote = op.remote_count
        await op.stop()
        op = None
        streams = [r["tokens"] for r in results]
        ref = stream_gates("planner two_pool", cfg, params, [r["prompt"] for r in results],
                           streams, [r["finish"] for r in results], max_tokens)
        launches = {k: r["kernel_launches"]["ragged_paged_attention_cuda.launches"]
                    for k, r in (("prefill-1", report_p1), ("prefill-2", report_p2))}
        result.update({
            "requests": len(results), "clients": POOL_CLIENTS, "max_tokens": max_tokens,
            "remote_count": remote, "decision_up": up, "decision_down": down,
            "prefill_decisions": [d["decision"] for d in dec if d["pool"] == "prefill"],
            "decode_decisions": decode_decisions,
            "crash": {"killed_pid": victim, "kill_to_planner_log_s": gap_s,
                      "kill_to_new_pid_in_state_s": respawn_s,
                      "kill_to_replacement_serving_s": t_serving - t_kill,
                      "planner_lines_since_kill": len(planner.lines) - seen_before},
            "up_to_second_prefill_ready_s": t_ready2 - up["unix"],
            "load_stop_to_prefill_down_s": down["unix"] - t_stop,
            "ttft_p50_ms": pct([r["ttft_ms"] for r in results], 50),
            "integrity": integrity, "degraded_requests": decode.degraded_requests,
            "prefill_worker_reports": {"1": report_p1, "2": report_p2},
            "prefill_worker_launches": launches, "planner_exit_code": planner_rc,
            "retired_prefill_exit_code": rc_p2,
            "wall_s": time.monotonic() - t_leg, **ref,
        })
        rep_ok = all(r["unified_dispatches"] and not r["mid_traffic_compiles"]
                     and r["kernel_launches"]["ragged_paged_attention_cuda.launches"]
                     == r["num_layers"] * r["unified_dispatches"]
                     for r in (report_p1, report_p2))
        if not (report_p2["requests"] >= 1 and launches["prefill-2"] > 0 and rep_ok
                and rc_p2 == "0"
                and all(d == ("hold", 1) for d in decode_decisions) and decode_decisions
                and gap_s <= PLANNER_TICK + 2.0
                and integrity["integrity_failures_total"] == 0
                and not decode.degraded_requests and planner_rc == 0
                and result["remote_count"] >= 2 * POOL_CLIENTS):
            fail(f"planner two_pool: {result}")
    except BaseException:
        dump_logs("planner two_pool", [planner], plogs + dlogs)
        raise
    finally:
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        for load in loads:
            await load.cancel()
        if op is not None:
            await op.stop()
        if planner is not None:
            await planner.kill()
        if decode is not None:
            await decode.stop()
        await front.shutdown()
        await server.stop()
    return result


async def phase_planner(vocab: int, params) -> dict:
    """Phase 11: the H100 calibration, then the planner over real
    llama3.2-1b workers (see the module docstring)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    t0 = time.monotonic()
    cfg = ModelConfig.llama32_1b()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_planner_")
    result: dict = {"phase": "planner"}
    try:
        result["calibration"] = await calibration_leg(card_line(), vocab)
        gc.collect()
        torch.cuda.empty_cache()
        result["aggregated"] = await aggregated_leg(tmp, cfg, params, vocab)
        emit({"phase": "planner_leg", **result["aggregated"]})
        result["two_pool"] = await two_pool_leg(tmp, cfg, params, vocab)
        emit({"phase": "planner_leg", **result["two_pool"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["wall_s"] = time.monotonic() - t0
    agg, pool = result["aggregated"], result["two_pool"]
    result["worker_launches"] = {
        **{f"aggregated-{k}": r["kernel_launches"]["ragged_paged_attention_cuda.launches"]
           for k, r in agg["worker_reports"].items()},
        **pool["prefill_worker_launches"]}
    emit({"phase": "planner", "wall_s": result["wall_s"],
          "worker_launches": result["worker_launches"],
          "summary": {
              "calibration_fit": result["calibration"]["fit"],
              "up_to_lease_s": agg["up_to_lease_s"],
              "up_to_new_worker_first_token_s": agg["up_to_new_worker_first_token_s"],
              "ttft_p50_before_up_ms": agg["ttft_p50_before_up_ms"],
              "ttft_p50_after_new_worker_ms": agg["ttft_p50_after_new_worker_ms"],
              "load_stop_to_down_s": agg["load_stop_to_down_s"],
              "crash": pool["crash"],
              "load_stop_to_prefill_down_s": pool["load_stop_to_prefill_down_s"]}})
    return result


# -- phase 12: the dense model families ----------------------------------------
FAMILIES_BUDGET_S = 120.0     # the phase's wall time ...
FAMILIES_PEAK_BYTES = 40e9    # ... and peak device memory, at most
GEMMA_LENS = (300, 1201)      # gemma3-1b prompts: local layers mask, global do not
MISTRAL_LENS = (4300, 4501)   # mistral-7b prompts: with 256 new tokens ...
MISTRAL_NEW = 256             # ... past the 4096 window
MISTRAL_REQUESTS = 2
QWEN_LENS = (64, 513)
FAMILY_HTTP_ARGS = [
    "run", "--out", "torch", "--model-path", "preset:gemma3-1b",
    "--num-blocks", "1024", "--max-num-seqs", "8", "--max-model-len", "2048",
    "--prefill-batch", "4", "--unified-token-budget", "256",
    "--unified-prefill-quantum", "64",
]


def family_config(model, **kw):
    from dynamo_tpu_torch.engine.config import EngineConfig

    return EngineConfig(**{
        "model": model, "dtype": "bfloat16", "block_size": 16, "num_blocks": 1024,
        "max_num_seqs": 8, "max_model_len": 2048, "prefill_batch": 4,
        "unified_token_budget": 256, "unified_prefill_quantum": 64, "seed": 0, **kw,
    })


def live_params(cfg, seed: int):
    """Random bf16 weights from ``seed`` on the card, then the family
    weights that start at identity (QK-norm and sandwich-norm gains, qkv
    biases) moved off it, so every family feature changes the served
    function."""
    from dynamo_tpu_torch.models import llama

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    params = llama.init_params(cfg, g, dtype=torch.bfloat16, device=DEVICE)
    for layer in params["layers"]:
        for k in ("ln_q_head", "ln_k_head", "ln_post_attn", "ln_post_mlp", "bq", "bk", "bv"):
            if k in layer:
                noise = torch.randn(layer[k].shape, generator=g, device=DEVICE)
                layer[k] += (0.1 * noise).to(layer[k].dtype)
    return params


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def poison_behind_window(c, window: int) -> int:
    """The rolling buffer's picture on a kernel case: each span's table
    entries wholly behind its first row's window become the 0 sentinel,
    and block 0 is filled with NaN (its int8 scales with inf), so a read
    of any page behind a window shows in the output. Returns the entries
    set to 0."""
    tables = c["tables"].cpu().numpy()
    bs, n = c["bs"], 0
    for s, (qs, ql) in enumerate(c["spans"]):
        first = max(qs - window + 1, 0) // bs if ql else 0
        tables[s, :first] = 0
        n += first
    c["tables"] = t_(tables)
    if "ks" in c:
        c["k"][:bs] = 127
        c["v"][:bs] = 127
        c["ks"][0] = float("inf")
        c["vs"][0] = float("inf")
    else:
        c["k"][:bs] = float("nan")
        c["v"][:bs] = float("nan")
    return n


def family_kernel_cases() -> dict:
    """The ragged kernel at the families' new shapes against its plain
    version, bf16 and int8 legs, unowned rows zero: gemma3-1b's (H, kvH,
    D) = (4, 1, 256) with window 512 in a mixed batch; mistral-7b's (32, 8,
    128) with window 4096 at contexts 4200–4700 over 320-column tables;
    each again with the entries behind every span's window set to the 0
    sentinel and block 0 poisoned. The unpoisoned cases are timed beside
    the fair library call."""
    rng = np.random.default_rng(12)
    bf16, int8 = torch.bfloat16, torch.int8
    shapes = [
        ("gemma_w512", (4, 1, 256, 16), 512, 256, 80, 1024,
         [(c - 1, 1) for c in (300, 511, 513, 700, 1024, 1200)]
         + [(0, 64), (480, 64), (900, 100), (0, 0)]),
        ("mistral_w4096", (32, 8, 128, 16), 4096, 192, 320, 2304,
         [(c - 1, 1) for c in (4200, 4350, 4511, 4700)]
         + [(4300, 64), (4100, 96), (0, 0)]),
    ]
    timed = {}
    for name, dims, window, T, max_blocks, num_blocks, spans in shapes:
        for kv in (None, int8):
            for poisoned in (False, True):
                case = f"{name}{'_int8' if kv else ''}{'_sentinel_nan' if poisoned else ''}"
                c = make_case(rng, spans, T, bf16, num_blocks=num_blocks,
                              max_blocks=max_blocks, dims=dims, kv_dtype=kv)
                zeroed = poison_behind_window(c, window) if poisoned else 0
                got = run_kernel(c, window)
                want = run_plain(c, window)
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got).all().item())
                pad_zero = bool((got[c["token_pos"] < 0] == 0).all().item())
                check("families", "ragged_" + case, {"max_abs_err": max_err(got, want)},
                      KERNEL_TOL[bf16], ok=finite and pad_zero,
                      kv_dtype=str(kv or bf16).split(".")[-1], T=T, spans=len(spans),
                      window=window, H_kvH_D_bs=list(dims), max_blocks=max_blocks,
                      splits_pages=ragged_plan(c, window), sentinel_entries=zeroed,
                      output_finite=finite, unowned_rows_zero=pad_zero)
                if not poisoned:
                    nbytes, flops = ragged_work(c, window)
                    library, rows = ragged_library(c, window)
                    timed[case] = timing(
                        "ragged_" + case, lambda c=c: run_kernel(c, window),
                        lambda c=c: run_plain(c, window), library,
                        run_plain(c, window)[rows], nbytes, flops, bf16)
                del c
                free_card()
    return timed


async def sample_blocks(engine, out: list) -> None:
    """(seconds, kv_active_blocks) every 5 ms until cancelled."""
    t0 = time.monotonic()
    while True:
        out.append((time.monotonic() - t0, engine.scheduler.metrics()["kv_active_blocks"]))
        await asyncio.sleep(0.005)


async def serve_family(ecfg, params, prompts, max_tokens, phase, evict=True,
                       profile_prompts=None, profile_tokens=32, limits=None,
                       record=False) -> tuple[dict, list]:
    """One family serve through ``TorchEngine.generate`` on given weights,
    with the ragged kernel's launches counted over exactly this serve and
    the phase 8 gates on its streams; optionally a profiled serve of
    ``profile_prompts`` (``profile_tokens`` each) after it.
    ``evict=False`` turns the rolling buffer's eviction off; ``limits``
    replaces phase 8's (``stream_gates``); ``record`` keeps the serve's
    dispatches under ``result["recorded"]``."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    cfg = ecfg.model
    engine = TorchEngine(ecfg, params=params, device=DEVICE)
    await engine.start()
    if not evict:
        engine.scheduler.evict_behind_window = lambda *a, **k: 0
    blocks: list = []
    profile = None
    try:
        capture = await warm_up(engine)
        recorded = record_dispatches(engine.runner) if record else None
        reset_counts()
        reset_wq()
        sampler = asyncio.create_task(sample_blocks(engine, blocks))
        try:
            streams, finishes, ttft, wall = await serve(engine, prompts, max_tokens)
        finally:
            sampler.cancel()
            if recorded is not None:
                recorded.stop()
        capture["mid_traffic_compiles_total"] = mid_traffic(engine)
        wq = wq_counts()
        launches = fn.launches
        paths = {"tc": fn.launches_tc, "split": fn.launches_split, "walk": fn.launches_walk}
        dispatches = engine.unified_dispatches
        gauges = {k: v for k, v in engine.readiness().items() if k.startswith("weight_quant_")}
        if profile_prompts is not None:
            profile = await profile_serve(engine, profile_prompts, profile_tokens)
    finally:
        await engine.stop()
    total = sum(len(s) for s in streams)
    late = [b for t, b in blocks if t >= wall / 2]
    result = {
        "phase": phase, "model": cfg.name, "dtype": ecfg.dtype,
        "kv_quant": ecfg.kv_quant, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts], "max_tokens": max_tokens,
        "generated_tokens": total, "wall_s": wall, "tokens_per_s": total / wall,
        "ttft_p50_ms": float(np.median(ttft)) * 1e3, "ttft_max_ms": max(ttft) * 1e3,
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "kernel_launches_by_path": paths, "num_layers": cfg.num_layers,
        "wq_gemm": wq, "weight_quant": gauges, "weight_bytes": param_bytes(params),
        "capture": capture, "rolling_buffer": cfg.rolling_buffer, "evict": evict,
        "kv_active_blocks_max": max((b for _, b in blocks), default=0),
        "kv_active_blocks_max_second_half": max(late, default=0),
        "device_ms_per_dispatch": profile and profile["device_ms_per_dispatch"],
        "device_busy_share": profile and profile["device_busy_share"],
        "top_kernels_ms": profile and profile["top_kernels_ms"][:6],
    }
    if cfg.is_moe and cfg.moe_dispatch != "dense":
        # Beside the reference with the serve's own dispatch, the
        # drop-free one: how far the batch-dependent drops moved it.
        free = teacher_forced(cfg.scaled(moe_dispatch="dense"), params, prompts, streams)
        result["drop_free_reference"] = {k: free[k] for k in (
            "greedy_agreement_vs_no_cache_reference", "disagreements",
            "max_logprob_gap_at_disagreement")}
    try:
        ref = stream_gates(phase, cfg, params, prompts, streams, finishes, max_tokens,
                           limits)
    except GateFailed:
        # The serve's line first, with the reference's numbers, then the
        # failure.
        ref = teacher_forced(cfg, params, prompts, streams)
        ref.pop("first_token_ref_logprob")
        emit({**result, **ref})
        raise
    result.update(ref)
    emit(result)
    check_capture(phase, capture)
    if launches != cfg.num_layers * dispatches or dispatches == 0:
        fail(f"{phase}: ragged launches for {dispatches} dispatches x "
             f"{cfg.num_layers} layers", launches, cfg.num_layers * dispatches)
    # Multi-row spans on the tensor-core tile in bf16, on the walk in f32.
    tile = "walk" if ecfg.dtype == "float32" else "tc"
    want = {"tc": 0, "walk": 0, tile: launches, "split": launches}
    if paths != want:
        fail(f"{phase}: ragged paths launched", paths, want)
    if recorded is not None:
        result["recorded"] = recorded.calls
    return result, streams


async def family_http(prompt, max_tokens, argv=FAMILY_HTTP_ARGS, phase="families_http",
                      limits=None) -> dict:
    """One streaming completion through the OpenAI server built by the
    CLI's own path on ``argv``'s preset (``preset:gemma3-1b``; its
    weights from the engine's seed), with a Tap on the engine's token
    ids: 200, 32 tokens with finish "length", the ragged kernel per
    dispatch, nothing captured mid-traffic, the stream through the phase
    8 gates (or ``limits``, as ``stream_gates`` takes them)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.pipeline import Tap

    args = cli.build_parser().parse_args(
        argv + ["--http-host", "127.0.0.1", "--http-port", "0"])
    cli.refuse_unserved(args)
    tapped: list[int] = []
    tap = Tap(on_request=lambda ctx: None,
              on_response=lambda ctx, item: tapped.extend(item["token_ids"]))
    async with contextlib.AsyncExitStack() as stack:
        service, engine = await cli.start_http(args, stack, engine_ops=(tap,))
        reset_counts()
        d0 = engine.unified_dispatches
        resp, timed = await http_stream(
            service.port, "/v1/completions",
            {"model": engine.cfg.model.name, "prompt": prompt, "stream": True, "temperature": 0,
             "max_tokens": max_tokens, "nvext": {"ignore_eos": True}})
        summary = stream_summary(timed)
        launches, dispatches = fn.launches, engine.unified_dispatches - d0
        capture = {**engine.runner.compile_stats.capture_snapshot(),
                   "mid_traffic_compiles_total": mid_traffic(engine)}
        cfg, params = engine.cfg.model, engine.runner.params
        finish = FinishReason.LENGTH if summary["finish"] == "length" else None
        gates = stream_gates(phase, cfg, params, [prompt], [tapped[:max_tokens]], [finish],
                             max_tokens, limits)
    result = {"phase": phase, "model": cfg.name, "status": resp.status,
              "tokens": len(tapped), "usage": summary["usage"],
              "finish": summary["finish"], "ttft_ms": summary["times"][0] * 1e3,
              "kernel_launches": launches, "unified_dispatches": dispatches,
              "capture": capture, **gates}
    emit(result)
    if resp.status != 200 or len(tapped) != max_tokens:
        fail(f"{phase}: status and tapped tokens", [resp.status, len(tapped)],
             [200, max_tokens])
    if capture["mid_traffic_compiles_total"]:
        fail(f"{phase}: mid-traffic captures", capture["mid_traffic_compiles_total"], 0)
    if launches != cfg.num_layers * dispatches or not dispatches:
        fail(f"{phase}: ragged launches", launches, cfg.num_layers * dispatches)
    return result


def phase_families(card: str) -> dict:
    """The dense model families at full width: see the module docstring
    (phase 12)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    peaks = []

    def take_peak() -> int:
        """The peak since the last fresh window."""
        peaks.append(torch.cuda.max_memory_allocated())
        return peaks[-1]

    def fresh_window() -> float:
        """Free what the last model left, then a fresh peak window."""
        free_card()
        torch.cuda.reset_peak_memory_stats()
        return time.monotonic()

    rng = np.random.default_rng(14)
    out = {"kernels": family_kernel_cases()}
    take_peak()
    stage_s = {"kernel_cases": time.monotonic() - t_phase}
    max_tokens = 32
    launches, per_model = {}, {}

    def model_line(name, served, t0):
        per_model[name] = {
            "tokens_per_s": served["tokens_per_s"], "ttft_p50_ms": served["ttft_p50_ms"],
            "device_ms_per_dispatch": served["device_ms_per_dispatch"],
            "peak_memory_bytes": take_peak(), "wall_s": time.monotonic() - t0}
        emit({"phase": "families_model", "model": name, "card": card, **per_model[name]})

    # gemma3-1b: bf16 and int8 KV, the OpenAI server, the phase split.
    t0 = fresh_window()
    gemma = ModelConfig.gemma3_1b()
    params = live_params(gemma, 1)
    prompts = [rng.integers(0, gemma.vocab_size, n).tolist()
               for n in rng.integers(*GEMMA_LENS, 8)]
    more = [rng.integers(0, gemma.vocab_size, n).tolist()
            for n in rng.integers(*GEMMA_LENS, 4)]
    ecfg = family_config(gemma)
    served, streams = asyncio.run(serve_family(ecfg, params, prompts, max_tokens,
                                               "families_gemma3-1b", profile_prompts=more))
    launches["gemma3-1b"] = served["kernel_launches"]
    served8, _ = asyncio.run(serve_family(family_config(gemma, kv_quant="int8"), params,
                                          prompts, max_tokens, "families_gemma3-1b_int8"))
    launches["gemma3-1b_int8"] = served8["kernel_launches"]
    phases = phase_phases(params, prompts[:PHASE_LANES], streams[:PHASE_LANES], max_tokens,
                          ecfg=family_config(gemma, prefill_chunk=2048),
                          phase="families_gemma3-1b_phases")
    out["phase_split"] = {k: phases[k] for k in (
        "prefill_kernel_launches", "decode_kernel_launches")}
    model_line("gemma3-1b", served, t0)
    del params
    fresh_window()
    http = asyncio.run(family_http(prompts[0], max_tokens))
    launches["gemma3-1b_http"] = http["kernel_launches"]
    take_peak()
    stage_s["gemma3-1b_http"] = time.monotonic() - t0 - per_model["gemma3-1b"]["wall_s"]

    # mistral-7b: the rolling buffer past its window, eviction on and off.
    t0 = fresh_window()
    mistral = ModelConfig.mistral_7b()
    params = live_params(mistral, 2)
    prompts = [rng.integers(0, mistral.vocab_size, n).tolist()
               for n in rng.integers(*MISTRAL_LENS, MISTRAL_REQUESTS)]
    more = [rng.integers(0, mistral.vocab_size, n).tolist()
            for n in rng.integers(*MISTRAL_LENS, MISTRAL_REQUESTS)]
    ecfg = family_config(mistral, num_blocks=768, max_num_seqs=4, prefill_batch=2,
                         max_model_len=5120, unified_token_budget=1024,
                         unified_prefill_quantum=512)
    on, on_streams = asyncio.run(serve_family(ecfg, params, prompts, MISTRAL_NEW,
                                              "families_mistral-7b", profile_prompts=more))
    off, off_streams = asyncio.run(serve_family(ecfg, params, prompts, MISTRAL_NEW,
                                                "families_mistral-7b_no_evict", evict=False))
    launches["mistral-7b"] = on["kernel_launches"]
    bs, w = ecfg.block_size, mistral.sliding_window
    plateau = MISTRAL_REQUESTS * (-(-w // bs) + 1 + (2 * ecfg.pipeline_depth) // bs + 1)
    grown = sum((len(p) + MISTRAL_NEW - 8) // bs for p in prompts)
    rolling = {"phase": "families_rolling_buffer", "model": mistral.name,
               "streams_identical": on_streams == off_streams,
               "kv_active_blocks_second_half": [on["kv_active_blocks_max_second_half"],
                                                off["kv_active_blocks_max_second_half"]],
               "plateau_bound": plateau, "grown_at_least": grown,
               "table_columns": ecfg.max_blocks_per_seq}
    emit(rolling)
    if not rolling["streams_identical"]:
        fail("families_rolling_buffer: streams with and without eviction differ",
             match_rate(on_streams, off_streams), 1.0)
    if on["kv_active_blocks_max_second_half"] > plateau:
        fail("families_rolling_buffer: live blocks with eviction",
             on["kv_active_blocks_max_second_half"], plateau)
    if off["kv_active_blocks_max"] < grown:
        fail("families_rolling_buffer: live blocks without eviction", off[
            "kv_active_blocks_max"], grown)
    model_line("mistral-7b", on, t0)
    del params

    # qwen3-0.6b and qwen2.5-0.5b: one bf16 serve each.
    for seed, model in ((3, ModelConfig.qwen3_06b()), (4, ModelConfig.qwen25_05b())):
        t0 = fresh_window()
        params = live_params(model, seed)
        prompts = [rng.integers(0, model.vocab_size, n).tolist()
                   for n in rng.integers(*QWEN_LENS, 8)]
        more = [rng.integers(0, model.vocab_size, n).tolist()
                for n in rng.integers(*QWEN_LENS, 4)]
        served, _ = asyncio.run(serve_family(family_config(model), params, prompts,
                                             max_tokens, f"families_{model.name}",
                                             profile_prompts=more))
        launches[model.name] = served["kernel_launches"]
        model_line(model.name, served, t0)
        del params

    wall = time.monotonic() - t_phase
    peak = max(peaks)
    stage_s.update({name: m["wall_s"] for name, m in per_model.items()})
    out.update({"phase": "families", "card": card, "wall_s": wall, "stage_s": stage_s,
                "peak_memory_bytes": peak, "models": per_model,
                "ragged_launches": launches,
                "budget": {"wall_s": FAMILIES_BUDGET_S, "peak_bytes": FAMILIES_PEAK_BYTES}})
    emit({k: v for k, v in out.items() if k != "kernels"})
    if peak > FAMILIES_PEAK_BYTES:
        fail("families: peak device memory", peak, FAMILIES_PEAK_BYTES)
    if wall > FAMILIES_BUDGET_S:
        fail("families: wall seconds", wall, FAMILIES_BUDGET_S)
    return out


# -- phase 13: DeepSeek-V2-Lite (MLA, yarn, routed + shared experts) ---------
MLA_DIMS = (16, 1, 576, 16)   # (H, kvH, D, bs): MLA's one latent head of 512 + 64


def sdpa_backends(call) -> dict:
    """Which scaled_dot_product_attention backends take the library
    yardstick's inputs: the one PyTorch picks (``_fused_sdp_choice``) and
    each that runs when forced."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    usable = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                call()
            torch.cuda.synchronize()
            usable.append(b.name)
        except RuntimeError:
            pass
    return {"usable": usable, "picked": picked_sdpa(call)}


def picked_sdpa(call) -> str | None:
    """The backend PyTorch's own choice gives the call's inputs (the
    last call's captured tensors), or None where it cannot be asked."""
    from torch.nn.attention import SDPBackend

    try:
        q, k, v, mask = call.inputs
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0, False)).name
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return None


def mla_kernel_cases() -> dict:
    """The ragged kernel at MLA's (H, kvH, D) = (16, 1, 576), block size
    16, against its plain version, on every leg (bf16 caches, int8 caches
    under bf16 q, float32) and path: a mixed T=256 batch (8 decode spans
    at contexts 600–2100, a 3-row verify span, prefill spans of 64, 64
    and 100 rows behind prefixes, an idle row), a tile-only batch
    (prefill spans; the walk in f32) and a split-only one (decode and
    verify spans). Unowned rows must be exactly zero. The mixed cases are
    timed beside one SDPA call over the gathered dense K/V."""
    rng = np.random.default_rng(15)
    bf16, f32, int8 = torch.bfloat16, torch.float32, torch.int8
    decode = [(c - 1, 1) for c in (600, 830, 1100, 1350, 1600, 1850, 2000, 2100)]
    prefill = [(0, 64), (700, 64), (1500, 100)]
    batches = {
        "mixed": (decode + [(1000, 3)] + prefill + [(0, 0)], 256),
        "tile": (prefill + [(0, 0)], 256),
        "split": (decode + [(1000, 3), (0, 0)], 16),
    }
    timed = {}
    for leg, dtype, kv in (("bf16", bf16, None), ("int8", bf16, int8), ("f32", f32, None)):
        for name, (spans, T) in batches.items():
            c = make_case(rng, spans, T, dtype, num_blocks=1800, max_blocks=136,
                          dims=MLA_DIMS, kv_dtype=kv)
            got = run_kernel(c)
            want = run_plain(c)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all().item())
            pad_zero = bool((got[c["token_pos"] < 0] == 0).all().item())
            check("mla", f"ragged_{leg}_{name}", {"max_abs_err": max_err(got, want)},
                  KERNEL_TOL[dtype], ok=finite and pad_zero, T=T, spans=len(spans),
                  H_kvH_D_bs=list(MLA_DIMS), splits_pages=ragged_plan(c),
                  output_finite=finite, unowned_rows_zero=pad_zero)
            if name == "mixed":
                nbytes, flops = ragged_work(c)
                library, rows = ragged_library(c)
                timed[leg] = timing(
                    f"ragged_mla_{leg}", lambda c=c: run_kernel(c), lambda c=c: run_plain(c),
                    library, run_plain(c)[rows], nbytes, flops, dtype)
                timed[leg]["max_abs_err"] = max_err(got, want)
                timed[leg]["sdpa"] = sdpa_backends(library)
                emit({"phase": "mla", "case": f"sdpa_{leg}", **timed[leg]["sdpa"]})
            del c
            free_card()
    return timed


MLA_BUDGET_S = 150.0          # the phase's wall time ...
MLA_PEAK_BYTES = 45e9         # ... and peak device memory, at most
MLA_LENS = (256, 1025)        # deepseek-v2-lite prompts
MLA_WITNESS_LAYERS = 8        # the deeper float32 witness: ~18 GB of weights
# The 27-layer bf16 legs' (agreement at least, largest gap in nats at
# most) against the no-cache reference. Phase 8's (0.9, 0.02) do not
# hold there: with random weights the top-k router turns bf16 rounding
# that depends on a product's shape into other experts (PERF.md §6,
# tools/layer_divergence.py). Each limit is the leg's reading on the H100
# (repeated exactly across runs: agreement 0.766, 0.598, 0.453, 0.656;
# gap 0.249, 1.025, 1.308, 0.385 nats) with a margin of 0.05 in
# agreement (0.1 for the one 32-token request) and about 0.25 nats in
# gap; a wrong expert path or model reads near 0 and several nats.
MLA_BF16_LIMITS = {
    "mla_bf16_dense": (0.71, 0.5),
    "mla_bf16_auto": (0.54, 1.3),
    "mla_bf16_auto_int8": (0.40, 1.55),
    "mla_http": (0.55, 0.65),
}
MLA_HTTP_ARGS = [
    "run", "--out", "torch", "--model-path", "preset:deepseek-v2-lite",
    "--num-blocks", "1024", "--max-num-seqs", "8", "--max-model-len", "2048",
    "--prefill-batch", "4", "--unified-token-budget", "256",
    "--unified-prefill-quantum", "64",
]


def seeded_params(cfg, seed: int, dtype, spec: str | None = None):
    """Random weights from ``seed``, drawn on the card tensor by tensor
    (one float32 draw at a time, cast there); with a weight-quant policy
    ``spec``, quantized as they are drawn (the same draws)."""
    from dynamo_tpu_torch.models import llama

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    policy = llama.WeightQuantPolicy.from_string(spec) if spec else None
    return llama.init_params(cfg, g, dtype=dtype, device=DEVICE, policy=policy)


def moe_rungs(ecfg) -> dict:
    """The expert formulation each budget rung's graphs capture."""
    from dynamo_tpu_torch.models.llama import moe_config

    mcfg = moe_config(ecfg.model)
    rungs, t = {}, 16
    while t <= ecfg.unified_token_budget:
        rungs[t] = "capacity" if mcfg.uses_capacity(t) else "dense"
        t *= 2
    return rungs


def capacity_replay(ecfg, params, recorded) -> dict:
    """The serve's first dispatch at a capacity rung (with the dispatches
    before it) through two fresh runners on the serve's weights: one
    replays its CUDA graphs, the other runs the eager step body. The
    sampled tokens and the K/V bytes outside trash block 0 must be
    identical."""
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.models.llama import moe_config

    mcfg = moe_config(ecfg.model)
    rows = [sum(len(lane[0]) for lane in call[0]) for call in recorded]
    first = next((i for i, n in enumerate(rows) if mcfg.uses_capacity(n)), None)
    if first is None:
        fail("mla_graphs: no recorded dispatch at a capacity rung", rows[:8], "T*k >= 2E")
    calls = recorded[:first + 1]
    graph = ModelRunner(ecfg, params=params, device=DEVICE)
    eager = ModelRunner(ecfg, params=params, device=DEVICE)
    got = replay_recorded(graph, graph.unified_step, calls, depth=1)[0]
    want = replay_recorded(eager, eager.unified_step_eager, calls, depth=1)[0]
    torch.cuda.synchronize()
    mismatch = [i for i, (a, b) in enumerate(zip(got, want)) if not np.array_equal(a, b)]
    where = cache_difference(graph, eager, ecfg.block_size)
    result = {"phase": "mla_graphs", "dispatch": first, "dispatch_rows": rows[first],
              "capacity": mcfg.capacity(rows[first]), "replayed": len(calls),
              "graphs_captured": graph.compile_stats.capture_snapshot()["graphs_captured"],
              "tokens_identical": not mismatch,
              "kv_bytes_identical_outside_trash_block": where is None,
              "first_difference": where}
    emit(result)
    if mismatch or where is not None:
        fail(f"mla_graphs: the graph replay differs from the eager body ({where})",
             mismatch, [])
    del graph, eager
    free_card()
    return result


def phase_mla(card: str) -> dict:
    """DeepSeek-V2-Lite at full width (phase 13): see the module
    docstring."""
    from dynamo_tpu_torch.models.config import ModelConfig

    t_phase = time.monotonic()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    # What earlier phases still hold counts toward this phase's peak.
    held_at_start = torch.cuda.memory_allocated()
    peaks, stage_s, per_leg = [], {}, {}

    def take_peak() -> int:
        peaks.append(torch.cuda.max_memory_allocated())
        return peaks[-1]

    def leg_line(name, served, t0):
        per_leg[name] = {
            "tokens_per_s": served["tokens_per_s"], "ttft_p50_ms": served["ttft_p50_ms"],
            "device_ms_per_dispatch": served["device_ms_per_dispatch"],
            "greedy_agreement_vs_no_cache_reference":
                served["greedy_agreement_vs_no_cache_reference"],
            "max_logprob_gap_at_disagreement": served["max_logprob_gap_at_disagreement"],
            "ragged_launches": served["kernel_launches"],
            "unified_dispatches": served["unified_dispatches"],
            "peak_memory_bytes": take_peak(), "wall_s": time.monotonic() - t0}
        emit({"phase": "mla_leg", "leg": name, "card": card, **per_leg[name]})
        free_card()   # the leg's engine, its cache and graph pool

    out = {"kernels": mla_kernel_cases()}
    take_peak()
    stage_s["kernel_cases"] = time.monotonic() - t_phase
    lite = ModelConfig.deepseek_v2_lite()
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, lite.vocab_size, n).tolist()
               for n in rng.integers(*MLA_LENS, 8)]
    more = [rng.integers(0, lite.vocab_size, n).tolist()
            for n in rng.integers(*MLA_LENS, 4)]
    max_tokens = 32

    # Witnesses at full width, drop-free, under phase 8's gates: float32
    # at 2 layers (layer 0 dense, layer 1 MoE) and MLA_WITNESS_LAYERS deep
    # (the walk, float32 products), and bf16 at 2 layers (the wide tile,
    # the bf16 expert products).
    for depth, dtype in ((2, "float32"), (MLA_WITNESS_LAYERS, "float32"), (2, "bfloat16")):
        t0 = time.monotonic()
        name = f"{'f32' if dtype == 'float32' else 'bf16'}_witness_{depth}"
        witness = lite.scaled(num_layers=depth, moe_dispatch="dense")
        params = seeded_params(witness, 1, getattr(torch, dtype))
        served, _ = asyncio.run(serve_family(family_config(witness, dtype=dtype), params,
                                             prompts, max_tokens, f"mla_{name}"))
        leg_line(name, served, t0)
        del params
        free_card()

    # 27 layers in bf16: drop-free, then the preset's auto, then int8 KV.
    t0 = time.monotonic()
    params = seeded_params(lite, 2, torch.bfloat16)
    stage_s["bf16_weights"] = time.monotonic() - t0
    dense = lite.scaled(moe_dispatch="dense")
    served, _ = asyncio.run(serve_family(
        family_config(dense), params, prompts, max_tokens, "mla_bf16_dense",
        profile_prompts=more, limits=MLA_BF16_LIMITS["mla_bf16_dense"]))
    leg_line("bf16_dense", served, t0)
    out["profile"] = {"device_ms_per_dispatch": served["device_ms_per_dispatch"],
                      "device_busy_share": served["device_busy_share"],
                      "top_kernels_ms": served["top_kernels_ms"]}
    t0 = time.monotonic()
    ecfg = family_config(lite)
    served, _ = asyncio.run(serve_family(ecfg, params, prompts, max_tokens, "mla_bf16_auto",
                                         limits=MLA_BF16_LIMITS["mla_bf16_auto"],
                                         record=True))
    recorded = served.pop("recorded")
    leg_line("bf16_auto", served, t0)
    out["rungs"] = moe_rungs(ecfg)
    out["graphs"] = capacity_replay(ecfg, params, recorded)
    del recorded
    t0 = time.monotonic()
    served, _ = asyncio.run(serve_family(family_config(lite, kv_quant="int8"), params,
                                         prompts, max_tokens, "mla_bf16_auto_int8",
                                         limits=MLA_BF16_LIMITS["mla_bf16_auto_int8"]))
    leg_line("bf16_auto_int8", served, t0)
    del params
    free_card()

    t0 = time.monotonic()
    http = asyncio.run(family_http(prompts[0], max_tokens, MLA_HTTP_ARGS, "mla_http",
                                   MLA_BF16_LIMITS["mla_http"]))
    take_peak()
    stage_s["http"] = time.monotonic() - t0
    free_card()

    wall = time.monotonic() - t_phase
    peak = max(peaks)
    stage_s.update({name: leg["wall_s"] for name, leg in per_leg.items()})
    out.update({"phase": "mla", "card": card, "model": lite.name,
                "params": lite.param_count(), "wall_s": wall, "stage_s": stage_s,
                "peak_memory_bytes": peak, "held_at_start_bytes": held_at_start,
                "legs": per_leg,
                "http": {k: http[k] for k in ("ttft_ms", "kernel_launches",
                                              "unified_dispatches",
                                              "greedy_agreement_vs_no_cache_reference",
                                              "max_logprob_gap_at_disagreement")},
                "bf16_limits [agreement at least, gap at most]": MLA_BF16_LIMITS,
                "budget": {"wall_s": MLA_BUDGET_S, "peak_bytes": MLA_PEAK_BYTES}})
    emit({k: v for k, v in out.items() if k != "kernels"})
    if peak > MLA_PEAK_BYTES:
        fail("mla: peak device memory", peak, MLA_PEAK_BYTES)
    if wall > MLA_BUDGET_S:
        fail("mla: wall seconds", wall, MLA_BUDGET_S)
    return out


# -- phase 14: multimodal (vision encode worker, unified_mm) and embeddings --
MM_BUDGET_S = 200.0           # the phase's wall time ...
MM_PEAK_BYTES = 30e9          # ... and peak device memory, at most
# ViT-B/16's published widths (Dosovitskiy et al. 2021, table 1) in the
# port's VisionConfig (the JAX package's fields): 196 patches an image,
# ~87M weights; its output is llama3.2-1b's hidden size.
MM_VISION = dict(image_size=224, patch_size=16, hidden_size=768, num_layers=12,
                 num_heads=12, mlp_ratio=4, out_dim=2048)
# The bf16 encoder's soft-prompt rows against the float32 encoder's on
# the same weights: the largest relative L2 error of a row (read 0.0105
# on the H100; three times that).
MM_ENCODER_TOL = 0.03
MM_REQUESTS = 8               # concurrent image chats ...
MM_TEXT = (64, 257)           # ... with this many text tokens ...
MM_TOKENS = 32                # ... and this many greedy tokens each
MM_EMBED_LENS = (16, 2049)    # embeddings inputs: 8 of this many tokens
MM_EMBED_COSINE = 0.995


def mm_url(arr: np.ndarray) -> str:
    import base64

    buf = io.BytesIO()
    np.save(buf, arr)
    return "data:application/x-npy;base64," + base64.b64encode(buf.getvalue()).decode()


def mm_rows(n: int, segs) -> tuple:
    """A prompt's soft-prompt rows: (embeds [n, D] float32, mask [n])
    on the card from (offset, [k, D]) segments, or (None, None)."""
    if not segs:
        return None, None
    D = segs[0][1].shape[1]
    embeds = torch.zeros((n, D), device=DEVICE)
    mask = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    for off, arr in segs:
        embeds[off:off + len(arr)] = torch.from_numpy(np.array(arr)).to(DEVICE)
        mask[off:off + len(arr)] = True
    return embeds, mask


def mm_encoder_check(vcfg, seed: int) -> tuple[dict, dict]:
    """``encode_image`` in bf16 against the same weights in float32 on
    seeded images; the bf16 encoder's ms per image. Returns (record, the
    bf16 params)."""
    from dynamo_tpu_torch.models.vision import encode_image, init_vision_params

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    f32 = init_vision_params(g, vcfg, dtype=torch.float32, device=DEVICE)
    bf16 = {k: ([{n: w.bfloat16() for n, w in layer.items()} for layer in v]
                if k == "layers" else v.bfloat16()) for k, v in f32.items()}
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(4):
        img = rng.random((vcfg.image_size, vcfg.image_size, 3), dtype=np.float32)
        want = encode_image(f32, vcfg, img)
        got = encode_image(bf16, vcfg, img)
        if tuple(got.shape) != (vcfg.num_patches, vcfg.out_dim) or not torch.isfinite(got).all():
            fail("multimodal: encoder output", list(got.shape), [vcfg.num_patches, vcfg.out_dim])
        errs.append(float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()))
    img = torch.from_numpy(rng.random((vcfg.image_size,) * 2 + (3,), dtype=np.float32)).to(DEVICE)
    ms = device_ms(lambda: encode_image(bf16, vcfg, img), 20)
    eager_ms = host_ms(lambda: encode_image(bf16, vcfg, img), 10)
    params = sum(w.numel() for k, v in f32.items()
                 for w in ([x for layer in v for x in layer.values()] if k == "layers" else [v]))
    del f32
    rec = {"vision": dict(MM_VISION), "params": params, "param_count": vcfg.param_count(),
           "patches": vcfg.num_patches, "max_row_rel_err_bf16_vs_f32": max(errs),
           "tol": MM_ENCODER_TOL, "encode_device_ms_per_image_bf16": ms,
           "encode_eager_wall_ms_per_image_bf16": eager_ms}
    if max(errs) > MM_ENCODER_TOL:
        fail("multimodal: bf16 encoder rows against float32", max(errs), MM_ENCODER_TOL)
    return rec, bf16


def mm_chat(model: str, text: str, urls: list[str], max_tokens: int) -> dict:
    content = [{"type": "text", "text": text}]
    content += [{"type": "image_url", "image_url": {"url": u}} for u in urls]
    return {"model": model, "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "nvext": {"ignore_eos": True}}


class MmTap:
    """The engine side of each request (a Tap before the router): its
    spliced prompt, its soft-prompt segments, its tokens and when the
    first one came."""

    def __init__(self) -> None:
        self.seen: dict[str, dict] = {}

    def op(self):
        from dynamo_tpu_torch.runtime.pipeline import Tap

        return Tap(self._request, self._response)

    def _request(self, ctx) -> None:
        segs = [(int(s["offset"]), np.frombuffer(s["data"], np.float32).reshape(s["shape"]))
                for s in ctx.payload.get("mm_segments") or []]
        self.seen[ctx.id] = {"prompt": list(ctx.payload["token_ids"]), "mm": segs,
                             "tokens": [], "t_first": None}

    def _response(self, ctx, item) -> None:
        rec = self.seen[ctx.id]
        if item.get("token_ids") and rec["t_first"] is None:
            rec["t_first"] = time.perf_counter()
        rec["tokens"].extend(item.get("token_ids") or [])

    def of(self, text: str, since: int = 0) -> dict:
        """The one request recorded after the first ``since`` whose
        prompt holds ``text``'s tokens."""
        from dynamo_tpu_torch.llm.multimodal import _find_sub
        from dynamo_tpu_torch.llm.tokenizer import ToyTokenizer

        needle = ToyTokenizer().encode(text)
        hits = [r for r in list(self.seen.values())[since:] if _find_sub(r["prompt"], needle) >= 0]
        if len(hits) != 1:
            fail("multimodal: tapped requests for one text", len(hits), 1)
        return hits[0]


async def mm_send(port: int, bodies: list[dict]) -> tuple[list, list, float]:
    """POST the streaming chats together; (responses, send times, wall)."""
    sent = [0.0] * len(bodies)

    async def one(i, body):
        sent[i] = time.perf_counter()
        resp, timed = await http_stream(port, "/v1/chat/completions", body)
        return resp, stream_summary(timed)

    t0 = time.perf_counter()
    out = await asyncio.gather(*(one(i, b) for i, b in enumerate(bodies)))
    return out, sent, time.perf_counter() - t0


async def mm_serve_leg(vcfg, vparams, rng) -> dict:
    """Image chats through the OpenAI server, the multimodal pipeline over
    an encode worker on the runtime plane, and the engine's unified_mm
    program; then the raw ``runner.prefill(mm_embeds=)`` entry point."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.examples.multimodal import deploy
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.multimodal import VisionEncodeEngine
    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
        paged_prefill_attention_cuda as prefill_fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    ecfg = full_width_config(multimodal=True)
    cfg = ecfg.model
    L = cfg.num_layers
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))

    def text(n):
        return "".join(rng.choice(letters, n))

    side = vcfg.image_size
    images = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in range(10)]
    odd = rng.integers(0, 256, (300, 200, 3), dtype=np.uint8)   # resized by the worker
    urls = [mm_url(im) for im in images] + [mm_url(odd)]
    bodies, texts = [], []
    for i in range(MM_REQUESTS):
        texts.append(text(int(rng.integers(*MM_TEXT))))
        n_img = 2 if i % 2 else 1
        chosen = [urls[-1]] if i == 0 else [urls[(2 * i + k) % 8] for k in range(n_img)]
        bodies.append(mm_chat(cfg.name, texts[-1], chosen, MM_TOKENS))

    engine = TorchEngine(ecfg, device=DEVICE)
    await engine.start()
    tap = MmTap()
    out: dict = {}
    try:
        capture = await warm_up(engine)
        mm_graphs = sorted(k for k in engine.runner.compile_stats.capture_s
                           if k.startswith("unified_mm"))
        encoder = await asyncio.to_thread(VisionEncodeEngine, vcfg, params=vparams,
                                          device=DEVICE)
        dep = await deploy(engine, encoder, ModelDeploymentCard(
            name=cfg.name, context_length=ecfg.max_model_len), engine_ops=(tap.op(),))
        step = engine.runner.unified_step
        mm_calls = {"dispatches": 0, "launches": 0, "events": []}

        def counting(lanes, feed=None, draft_lens=None, extras=None, mm=None):
            if mm is None or not any(mm):
                return step(lanes, feed=feed, draft_lens=draft_lens, extras=extras, mm=mm)
            before = fn.launches
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            res = step(lanes, feed=feed, draft_lens=draft_lens, extras=extras, mm=mm)
            e1.record()
            mm_calls["dispatches"] += 1
            mm_calls["launches"] += fn.launches - before
            mm_calls["events"].append((e0, e1))
            return res

        engine.runner.unified_step = counting
        try:
            port = dep.service.port
            reset_counts()
            d0, p0 = engine.unified_dispatches, engine.unified_prefill_tokens
            resps, sent, wall = await mm_send(port, bodies)
            launches, dispatches = fn.launches, engine.unified_dispatches - d0
            paths = {"tc": fn.launches_tc, "split": fn.launches_split, "walk": fn.launches_walk}
            torch.cuda.synchronize()
            mm_ms = [a.elapsed_time(b) for a, b in mm_calls["events"]]
            recs = [tap.of(t) for t in texts]
            ttft = [r["t_first"] - s for r, s in zip(recs, sent)]
            streams = [r["tokens"][:MM_TOKENS] for r in recs]
            finishes = [FinishReason.LENGTH if s["finish"] == "length" else None
                        for _, s in resps]
            n_seen = len(tap.seen)
            # One image request alone, twice; the same text with another image.
            alone = []
            reused0 = engine._reused_device_blocks
            for body in (bodies[1], bodies[1],
                         mm_chat(cfg.name, texts[1], [urls[8], urls[9]], MM_TOKENS)):
                await mm_send(port, [body])
                alone.append(tap.of(texts[1], n_seen + len(alone))["tokens"])
            reused = engine._reused_device_blocks - reused0
            # A text-only request alone on the mm engine.
            plain_text = text(int(rng.integers(*MM_TEXT)))
            (plain_resp,), plain_sent, _ = await mm_send(
                port, [mm_chat(cfg.name, plain_text, [], MM_TOKENS)])
            plain = tap.of(plain_text)
            plain_ttft = plain["t_first"] - plain_sent[0]
            capture["mid_traffic_compiles_total"] = mid_traffic(engine)
            capture["mid_traffic_keys"] = engine.runner.compile_stats.capture_snapshot()[
                "mid_traffic_keys"]
        finally:
            del engine.runner.unified_step
            await dep.stop()
        params = engine.runner.params
    finally:
        await engine.stop()
    gates = stream_gates("multimodal", cfg, params, [r["prompt"] for r in recs], streams,
                         finishes, MM_TOKENS, mm=[r["mm"] for r in recs])
    # The control: the same streams against the reference with the
    # placeholder tokens' own embeddings (no image rows spliced).
    unspliced = teacher_forced(cfg, params, [r["prompt"] for r in recs], streams)
    total = sum(len(s) for s in streams)
    out.update({
        "model": cfg.name, "requests": MM_REQUESTS, "images": [len(b["messages"][0]["content"]) - 1
                                                               for b in bodies],
        "prompt_lens": [len(r["prompt"]) for r in recs], "max_tokens": MM_TOKENS,
        "statuses": [r.status for r, _ in resps], "wall_s": wall, "tokens_per_s": total / wall,
        "ttft_p50_ms_mm": float(np.median(ttft)) * 1e3, "ttft_max_ms_mm": max(ttft) * 1e3,
        "ttft_ms_text_only": plain_ttft * 1e3,
        "unified_dispatches": dispatches, "mm_dispatches": mm_calls["dispatches"],
        "prefill_tokens": engine.unified_prefill_tokens - p0,
        "device_ms_per_mm_dispatch": float(np.mean(mm_ms)) if mm_ms else None,
        "kernel_launches": launches, "kernel_launches_by_path": paths,
        "mm_kernel_launches": mm_calls["launches"], "capture": capture,
        "unified_mm_graphs": mm_graphs, "encoder_images": encoder.images,
        "alone_twice_identical": alone[0] == alone[1],
        "other_image_differs": alone[2] != alone[0],
        "kv_reused_device_blocks_delta": reused, **gates,
        "agreement_vs_reference_without_images":
            unspliced["greedy_agreement_vs_no_cache_reference"]})
    if any(r.status != 200 for r, _ in resps) or plain_resp[0].status != 200:
        fail("multimodal: statuses", out["statuses"] + [plain_resp[0].status], 200)
    check_capture("multimodal", capture)
    if mm_graphs != ["unified_mm:t256:greedy", "unified_mm:t256:sampled"]:
        fail("multimodal: unified_mm graphs captured before traffic", mm_graphs,
             ["unified_mm:t256:greedy", "unified_mm:t256:sampled"])
    if launches != L * dispatches or not dispatches:
        fail("multimodal: ragged launches", launches, L * dispatches)
    if paths != {"tc": launches, "split": launches, "walk": 0}:
        fail("multimodal: ragged paths", paths, {"tc": launches, "split": launches, "walk": 0})
    if mm_calls["launches"] != L * mm_calls["dispatches"] or mm_calls["dispatches"] < MM_REQUESTS:
        fail("multimodal: ragged launches in mm dispatches", mm_calls["launches"],
             L * mm_calls["dispatches"])
    if alone[0] != alone[1] or len(alone[0]) != MM_TOKENS:
        fail("multimodal: one image request alone twice", alone[:2], "byte-identical")
    if reused:
        fail("multimodal: blocks reused across images", reused, 0)
    # The images reach the model: the streams part from the reference
    # that keeps the placeholder tokens' own embeddings.
    if out["agreement_vs_reference_without_images"] > 0.5:
        fail("multimodal: agreement with the reference without the images",
             out["agreement_vs_reference_without_images"], 0.5)
    out["raw_prefill"] = await asyncio.to_thread(
        mm_raw_prefill, ecfg, params, min((r for r in recs if len(r["mm"]) == 1),
                                          key=lambda r: len(r["prompt"])), prefill_fn)
    # The same text-only request, alone, on an engine without multimodal.
    other = TorchEngine(full_width_config(), device=DEVICE)
    await other.start()
    try:
        await warm_up(other)
        got, *_ = await serve(other, [plain["prompt"]], MM_TOKENS)
    finally:
        await other.stop()
    out["text_only_equal_to_plain_engine"] = got[0] == plain["tokens"][:MM_TOKENS]
    if not out["text_only_equal_to_plain_engine"]:
        fail("multimodal: text-only stream against the engine without multimodal",
             plain["tokens"][:MM_TOKENS], got[0])
    return out


def mm_raw_prefill(ecfg, params, rec, prefill_fn) -> dict:
    """One ``runner.prefill(..., mm_embeds=)`` at full width on a runner
    of its own (the served weights): the paged prefill kernel once per
    layer, and its first token the reference's argmax with the same rows
    spliced."""
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.models import llama

    runner = ModelRunner(dataclasses.replace(ecfg, num_blocks=64), params=params, device=DEVICE)
    prompt, segs = rec["prompt"], rec["mm"]
    blocks = list(range(1, (len(prompt) + ecfg.block_size - 1) // ecfg.block_size + 1))
    before = prefill_fn.launches
    tok = runner.prefill(prompt, blocks, 0, (0.0, 0, 1.0), mm_embeds=segs)
    launches = prefill_fn.launches - before
    embeds, mask = mm_rows(len(prompt), segs)
    logits = llama.reference_forward(ecfg.model, params, torch.tensor(prompt, device=DEVICE),
                                     embeds, mask)[-1].float()
    lp = torch.log_softmax(logits, -1)
    want = int(lp.argmax())
    text_only = llama.reference_forward(ecfg.model, params,
                                        torch.tensor(prompt, device=DEVICE))[-1].float()
    out = {"prompt_len": len(prompt), "image_rows": sum(len(a) for _, a in segs),
           "prefill_mm": launches, "token": tok, "reference_argmax": want,
           "logprob_gap": float(lp[want] - lp[tok]),
           "max_abs_logit_change_from_the_images": float((logits - text_only).abs().max())}
    del runner
    if launches != ecfg.model.num_layers:
        fail("multimodal: raw mm prefill kernel launches", launches, ecfg.model.num_layers)
    if tok != want:
        fail("multimodal: raw mm prefill first token against the reference", tok, want)
    return out


async def embeddings_leg(child, port: int, rng) -> dict:
    """8 inputs of 16–2048 tokens through ``run --model-type embeddings``
    (text and token ids, one POST each kind, every input its own request
    inside): unit norm, and cosine against ``embed_forward`` in float32
    on the card with the same (seeded) weights."""
    from dynamo_tpu_torch.llm.embedding import embed_forward
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.tokenizer import ToyTokenizer
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama32_1b()
    lens = sorted(int(n) for n in rng.integers(*MM_EMBED_LENS, 8))
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    texts = ["".join(rng.choice(letters, n)) for n in lens[::2]]
    ids = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens[1::2]]
    await child.wait_for(r"OpenAI server on", 240.0)
    posts, walls = [], []
    for inputs in (texts, ids):
        t0 = time.perf_counter()
        resp = await fetch("127.0.0.1", port, "POST", "/v1/embeddings",
                           {"model": cfg.name, "input": inputs})
        walls.append(time.perf_counter() - t0)
        if resp.status != 200:
            fail("multimodal: /v1/embeddings status", resp.status, 200)
        posts.append(resp.json())
    vecs = [d["embedding"] for p in posts for d in p["data"]]
    inputs = [ToyTokenizer().encode(t) for t in texts] + ids
    # The server's weights: EmbeddingEngine's seed 0 on the card, bf16;
    # the reference widens them to float32.
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    params = llama.init_params(cfg, g, dtype=torch.bfloat16, device=DEVICE)
    params = {k: ([{n: w.float() for n, w in layer.items()} for layer in v]
                  if k == "layers" else v.float()) for k, v in params.items()}
    norms, cosines = [], []
    with torch.inference_mode():
        for vec, toks in zip(vecs, inputs):
            got = torch.tensor(vec, device=DEVICE)
            want = embed_forward(cfg, params, torch.tensor(toks, device=DEVICE), len(toks))
            norms.append(float(got.norm()))
            cosines.append(float(torch.dot(got, want) / (got.norm() * want.norm())))
    del params
    tokens = sum(len(t) for t in inputs)
    out = {"inputs": len(vecs), "tokens": [len(t) for t in inputs],
           "usage_prompt_tokens": [p["usage"]["prompt_tokens"] for p in posts],
           "norms": norms, "cosine_vs_f32": cosines, "min_cosine": min(cosines),
           "ms_per_request": 1e3 * sum(walls) / len(vecs), "tokens_per_s": tokens / sum(walls)}
    if len(vecs) != 8 or any(abs(n - 1.0) > 1e-3 for n in norms):
        fail("multimodal: embeddings norms", norms, "1 ± 1e-3")
    if min(cosines) < MM_EMBED_COSINE:
        fail("multimodal: embeddings cosine against float32", min(cosines), MM_EMBED_COSINE)
    usage = [sum(len(t) for t in inputs[:len(texts)]), sum(len(t) for t in ids)]
    if out["usage_prompt_tokens"] != usage:
        fail("multimodal: embeddings usage", out["usage_prompt_tokens"], usage)
    return out


def phase_multimodal(card: str) -> dict:
    """Image chat through a vision encode worker and /v1/embeddings on
    llama3.2-1b at full width (phase 14): see the module docstring."""
    from dynamo_tpu_torch.models.vision import VisionConfig

    t_phase = time.monotonic()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    held_at_start = torch.cuda.memory_allocated()
    rng = np.random.default_rng(16)
    vcfg = VisionConfig(**MM_VISION)
    encoder, vparams = mm_encoder_check(vcfg, 16)
    emit({"phase": "multimodal_encoder", "card": card, **encoder})

    async def run() -> tuple[dict, dict]:
        import signal

        port = free_port()
        child = await Child("embeddings", [
            "run", "--in", "http", "--out", "torch", "--model-type", "embeddings",
            "--model-path", "preset:llama3.2-1b", "--http-host", "127.0.0.1",
            "--http-port", str(port)]).start()
        try:
            serve_out = await mm_serve_leg(vcfg, vparams, rng)
            free_card()
            emb = await embeddings_leg(child, port, rng)
        finally:
            child.signal(signal.SIGTERM)
            with contextlib.suppress(GateFailed):
                await child.exit_code(60.0)
            await child.kill()
        return serve_out, emb

    serve_out, emb = asyncio.run(run())
    del vparams
    free_card()
    wall = time.monotonic() - t_phase
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "multimodal", "card": card, "encoder": encoder, **serve_out,
           "embeddings": emb, "phase_wall_s": wall, "peak_memory_bytes": peak,
           "held_at_start_bytes": held_at_start,
           "budget": {"wall_s": MM_BUDGET_S, "peak_bytes": MM_PEAK_BYTES}}
    emit(out)
    if peak > MM_PEAK_BYTES:
        fail("multimodal: peak device memory", peak, MM_PEAK_BYTES)
    if wall > MM_BUDGET_S:
        fail("multimodal: wall seconds", wall, MM_BUDGET_S)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        fail("nvidia-smi reported no card")
    return out


def family_timing(families: dict, leg: str) -> dict:
    """The ragged kernel's times at the families' shapes, one leg."""
    return {name: {k: t[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by")}
            for name, t in families["kernels"].items()
            if name.endswith("_int8") == (leg == "_int8")}


def kernel_entry(name, source, replaces, launches, t, design, **extra) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "design": design,
        **extra,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    become_subreaper()
    try:
        return run_all()
    except BaseException as exc:
        # One line naming the phase, the gate, its value and its limit, on
        # both streams; the exit stays non-zero.
        line = json.dumps({"failed": failure_record(exc)})
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)
        raise
    finally:
        # No process this script started outlives it, whatever failed.
        for name in stop_leftovers():
            print(f"chip_smoke: stopped a process left running: {name[:300]}",
                  file=sys.stderr, flush=True)


def run_all() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    # The full-width serves' prompts; the phase-split run takes the first
    # PHASE_LANES of them, and the decode and prefill kernels' main cases
    # are that run's.
    rng = np.random.default_rng(1)
    vocab = full_width_config().model.vocab_size
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    more = [rng.integers(0, vocab, n).tolist() for n in lens]
    max_tokens = 32
    phase_lens = [int(n) for n in lens[:PHASE_LANES]]

    run_phase("build", phase_build)
    t_ragged, t_int8 = run_phase("ragged", phase_ragged)
    t_decode = run_phase("decode", phase_decode, phase_lens, max_tokens)
    t_prefill = run_phase("prefill", phase_prefill, phase_lens, max_tokens)
    run_phase("tiny", phase_tiny)

    served, engine, streams = run_phase("serve", serve_full, full_width_config(), prompts,
                                        max_tokens, "serve", more)
    run_phase("graphs", phase_graphs, engine.runner.params, served.pop("recorded"), None,
              "graphs")
    served_int8, _, streams_int8 = run_phase(
        "serve_int8", serve_full, full_width_config(kv_quant="int8"), prompts,
        max_tokens, "serve_int8", more)
    emit({"phase": "serve_int8_vs_bf16",
          "greedy_match_rate": match_rate(streams_int8, streams)})
    run_phase("graphs_int8", phase_graphs, engine.runner.params,
              served_int8.pop("recorded"), "int8", "graphs_int8")
    run_phase("spec", phase_spec, prompts + repeated_prompts(rng, vocab), max_tokens)
    http = run_phase("http", phase_http, prompts, streams, max_tokens, served, more[:2])
    observe = run_phase("observe", phase_observe, vocab)
    phases = run_phase("phases", phase_phases, engine.runner.params,
                       prompts[:PHASE_LANES], streams[:PHASE_LANES], max_tokens)
    # The files phase leaves its llama3.2-1b checkout for wquant to load.
    keep = tempfile.mkdtemp(prefix="chip_smoke_checkout_")
    try:
        checkout = os.path.join(keep, "llama3.2-1b")
        files = run_phase("files", phase_files, engine.runner.params, prompts, streams,
                          max_tokens, card, checkout)
        wquant = run_phase("wquant", phase_wquant, card, prompts, more, streams, served,
                           checkout)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # The fleet's workers are processes of their own on this card: free
    # this process's engines first, keeping the serve's weights (the
    # workers make the same ones from the same seed) for the gates.
    params = engine.runner.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    fleet = run_phase("fleet", phase_fleet, prompts, max_tokens, http, params)
    disagg = run_phase("disagg", phase_disagg, vocab, max_tokens, params)
    gc.collect()
    torch.cuda.empty_cache()
    planner = run_phase("planner", phase_planner, vocab, params)
    del params
    free_card()
    families = run_phase("families", phase_families, card)
    mla = run_phase("mla", phase_mla, card)
    mm = run_phase("multimodal", phase_multimodal, card)

    print(card, flush=True)
    ragged_src = "dynamo_tpu_torch/csrc/ragged_attention.cu"
    ragged = ("3 launches: spans of <= 4 rows split-KV over table columns "
              "(paged_split.cuh, cp.async ring) on a second stream beside the "
              "longer spans' mma.sync m16n8k16 tile of 128 query vectors "
              "(paged_attention_tc.cuh; the f32 walk for f32 q), then a merge pass "
              "that also zeroes unowned rows")
    emit({"kernels": [
        kernel_entry("ragged_paged_attention", ragged_src,
                     "dynamo_tpu/ops/pallas/ragged_attention.py:67",
                     served["kernel_launches"], t_ragged, ragged,
                     launches_by_path=served["kernel_launches_by_path"],
                     observe_launches=observe["kernel_launches"],
                     fleet_worker_launches={
                         w: r["kernel_launches"]["ragged_paged_attention_cuda.launches"]
                         for w, r in fleet["bf16_workers"].items()},
                     disagg_launches={
                         **{leg: disagg[leg]["kernel_launches"]
                            for leg in ("device", "tcp", "native")},
                         "prefill_worker": disagg["worker_bf16"]["ragged_launches"],
                         "kvbm": disagg["kvbm"]["ragged_launches"],
                         "g4": disagg["g4"]["ragged_launches"]},
                     planner_worker_launches=planner["worker_launches"],
                     families_launches={k: v for k, v in families["ragged_launches"].items()
                                        if not k.endswith("_int8")},
                     families_timing=family_timing(families, ""),
                     multimodal_launches=mm["kernel_launches"],
                     files_launches={k: v for k, v in files["ragged_launches"].items()
                                     if not k.startswith("deepseek")},
                     multimodal_mm_dispatch_launches=mm["mm_kernel_launches"]),
        kernel_entry("ragged_paged_attention_int8", ragged_src,
                     "dynamo_tpu/ops/pallas/ragged_attention.py:227",
                     served_int8["kernel_launches"], t_int8,
                     ragged + "; int8 pages unscaled in bf16, k scale on the f32 "
                     "scores, v scale on P", launches_by_path=served_int8[
                         "kernel_launches_by_path"],
                     disagg_launches={"tcp": disagg["int8"]["kernel_launches"],
                                      "prefill_worker": disagg["worker_int8"][
                                          "ragged_launches"]},
                     families_launches={k: v for k, v in families["ragged_launches"].items()
                                        if k.endswith("_int8")},
                     families_timing=family_timing(families, "_int8")),
        kernel_entry("ragged_paged_attention_mla", ragged_src,
                     "dynamo_tpu/ops/pallas/ragged_attention.py:67",
                     mla["legs"]["bf16_dense"]["ragged_launches"], mla["kernels"]["bf16"],
                     "at MLA's (H, kvH, D) = (16, 1, 576): spans of <= 4 rows split-KV "
                     "(paged_split.cuh, 2-stage ring, 72 accumulators a thread) beside "
                     "the wide tile (paged_attention_wide.cuh: 16 query vectors, S by "
                     "warp over 8 keys, P in shared memory, P.V by warp over 144 "
                     "columns), then the merge",
                     launches_by_leg={k: v["ragged_launches"] for k, v in mla["legs"].items()},
                     files_launches={k: v for k, v in files["ragged_launches"].items()
                                     if k.startswith("deepseek")},
                     http_launches=mla["http"]["kernel_launches"],
                     int8=mla["kernels"]["int8"], f32=mla["kernels"]["f32"]),
        kernel_entry("wq_gemm", "dynamo_tpu_torch/csrc/wq_gemm.cu",
                     "none (no pl.pallas_call): the XLA fusion of dynamo_tpu/ops/quant.py:119 "
                     "qmm", wquant["legs"]["llama3.2-1b_int8"]["wq_gemm"]["launches"],
                     wquant["kernel"],
                     "out^T = q^T a^T: int8/e4m3 weight tiles and bf16 activation tiles by "
                     "TMA (a producer thread, an mbarrier ring), the weight converted to "
                     "bf16 in registers as wgmma's A, activations its B from 128-byte "
                     "swizzled shared memory, tokens its N (16, 64, 128 or 256); two "
                     "consumer warpgroups, a persistent grid, the column scale in the "
                     "epilogue; few tiles split K and the last split to arrive sums the "
                     "partials in split order (one launch); f32 activations on a SIMT loop",
                     main_case=WQ_MAIN_CASE, max_rel_err=wquant["kernel"]["max_rel_err"],
                     launches_by_leg={
                         **{k: v["wq_gemm"] for k, v in wquant["legs"].items()},
                         **{f"llama3-8b_{k}": v["wq_gemm"]
                            for k, v in wquant["llama3-8b"].items()},
                         **{f"deepseek_{k}": v["wq_gemm"]
                            for k, v in wquant["deepseek"].items()},
                         "http": wquant["http"]["wq_gemm"]}),
        kernel_entry("paged_decode_attention",
                     "dynamo_tpu_torch/csrc/paged_decode_attention.cu",
                     "dynamo_tpu/ops/pallas/attention.py:91",
                     phases["decode_kernel_launches"], t_decode,
                     "split-KV over table columns, cp.async ring, merge kernel",
                     families_launches={"gemma3-1b": families["phase_split"][
                         "decode_kernel_launches"]}),
        kernel_entry("paged_prefill_attention",
                     "dynamo_tpu_torch/csrc/paged_prefill_attention.cu",
                     "dynamo_tpu/ops/pallas/attention.py:405",
                     phases["prefill_kernel_launches"], t_prefill,
                     "bf16: mma.sync m16n8k16 tile of 128 query vectors "
                     "(paged_attention_tc.cuh); f32: the walk",
                     families_launches={"gemma3-1b": families["phase_split"][
                         "prefill_kernel_launches"]},
                     prefill_mm=mm["raw_prefill"]["prefill_mm"]),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
