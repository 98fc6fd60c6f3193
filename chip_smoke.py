#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (veles.simd_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises, and the script exits non-zero
without printing a result):

1. card   — a reachability probe in a subprocess
            (``utils.platform.require_reachable_device``), then the
            card's name and count under ``init_deadline``, its power
            limit, and one ``probes`` line (``probe_history()``); no
            CUDA card is a failure (the port is never smoke-run on the
            CPU);
2. build  — builds the CUDA kernels from csrc/ with nvcc (sm_90a); the
            build counts as ``compile.backend_compile`` (its seconds in
            ``compile.backend_compile_secs``), a library found built as
            ``compile.cache_hits``;
3. parity — each kernel against its plain PyTorch version run in
            float64 on the card, at the main path's shapes and at the
            edge cases (K2 and K5 also through their padded entries, the
            halo read in the kernel, as the direct routes call them; K3
            in both forms: the contract on an extended input, and the
            periodic form that reads the wrap and writes natural order,
            as the fused cascade calls it);
4. main   — the main path through the user entry points, launch
            counters reset just before each call and read just after:
            ``convolve_initialize(1<<20, 2047)`` + ``convolve`` (the
            overlap-save kernel), a matched filter through
            ``cross_correlate_initialize`` (peak at pos + k - 1), and
            ``convolve_simd`` on 512 x 16384 with 129 taps (the
            filter-bank kernel); the wavelet slice on 512 x 4096 daub8
            (``wavelet_apply`` and ``stationary_wavelet_apply`` through
            the filter-bank kernel, the 3-level cascade as a loop of
            ``wavelet_apply`` and as ``wavelet_transform``, whose
            default is one cascade-bank launch, also at 4 x 2^20 and
            on one signal of 2^16, a DWT round trip); and
            ``convolve2d`` on 16 x 512 x 512 with 7 x 7 (the 2D
            kernel; also ``mode='same'`` and ``boundary='wrap'``),
            ``cross_correlate2d`` and a 2D ``fftconvolve``;
            the spectral slice: ``stft`` on 2^20 samples at 512/128
            through the auto route (the fused STFT kernel) and the
            forced ``rdft_matmul`` and ``xla_fft`` routes,
            ``batched_stft`` (the STFT kernel), ``spectrogram``, the
            ``istft(stft(x))`` round trip and ``welch`` on 64 x 16384,
            ``hilbert``/``envelope`` at n = 1024 and 65536, and
            ``morlet_cwt`` on 8 x 4096 with 32 scales (``ct_matmul``);
            each within 1e-4 of a float64 oracle;
            then the ``resources`` line: one main-path call per kernel
            (the headline, ``convolve_simd``, the DWT, the fused
            cascade, ``convolve2d``, ``stft``), each after
            ``obs.reset()``, whose ``("cuda", route)`` row of
            ``obs.resources()`` carries ``utils.benchmark``'s work at
            that shape and at most 100 % of the roofline; then the
            ``resources ops`` line: one public op of each other family
            the JAX package instruments (``OPS_RESOURCE_ROWS``, 64 x
            16,384 float32, a 1024^2 gemm, 16 x 512^2 2D), each leaving
            exactly its JAX key with its literal work, in under 15 s;
4b. reference — the reference-header surface through its entry
            points, each op against a float64 NumPy oracle, then timed
            (chained CUDA events; host clock where a call ends on the
            host): BASELINE config 1 (bench.py's 4096 x 4096
            int16_to_float / real_multiply / add_to_all /
            float_to_int16 step, exact; complex_multiply(_conjugate) on
            2^23 pairs; sum_elements; float_to_int32 saturation),
            config 2 (sin/cos/log/exp/pow/sqrt on 1M floats, max ulp;
            log_psv's ulp on U[0.1, 5] and its special values),
            config 3 (sgemm and gemv at 512; matrix_multiply 2048^3 on
            every precision route, each within its ERROR_BUDGETS entry,
            with its device kernels, the fp32 route's free of TF32),
            normalize2D on 64 x 1024^2 u8, detect_peaks /
            detect_peaks_fixed / find_peaks on 2^20 samples (exact vs
            the oracles), medfilt / savgol_filter / wiener on
            64 x 16384 and medfilt2d 3 x 3 on 16 x 512^2;
4c. dsp  — the IIR and resampling families through their entry
            points at the JAX bench's shapes, nothing cut: ``sosfilt``
            and ``batched_sosfilt`` (butterworth(4, 0.25)) on
            64 x 16384 and 1 x 16384, ``sosfiltfilt`` and
            ``decimate(ftype='iir', factor=4)`` (cheby1(8, 0.05, 0.2))
            on 64 x 16384, ``batched_lfilter`` (order 3) on 64 x 16384,
            ``StreamingSosfilt`` over 8 blocks of 2048 (equal to the
            one-shot call), ``resample_poly`` 160/147 (3201 taps) on
            2^20 samples, ``batched_resample_poly`` 160/147 on
            256 x 4096, FIR ``decimate`` by 4 on 2^20 and
            ``resample_fourier`` on 2^20 to the same length as 160/147;
            each against a float64 oracle (IIR 2e-5 of max|y|, the FIR
            resamplers 2e-5, Fourier 1e-4), with its chained ms (CUDA
            events), device busy ms and kernels a call (CUPTI's
            records, ``utils.devtrace``), Msamples/s and the bound of its least
            bytes; no csrc kernel, no TF32 kernel;
4d. faults — the fault policy through the entry points at full size,
            with injected plans and no backoff: the headline with
            ``convolve.os_cuda:vmem_oom:1`` (demoted, no K1 launch on
            that call or the next, within 1e-4 of float64),
            ``convolve.dispatch:device_lost:2`` (retried, answered by
            K1), ``stft`` 2^20 at 512/128 with
            ``spectral.stft_cuda:vmem_oom:1``, ``convolve2d`` 16 x 512^2
            7 x 7 with ``convolve2d.direct_cuda:vmem_oom:1``, and a
            breaker opened by ``convolve.dispatch:device_lost:9999`` on
            host input that short-circuits to the oracle and recloses
            once the plan clears; the same device loss and a refused
            K1 launch with operands already on the card, which
            re-raise (no oracle, no demotion, nothing remembered);
            ``packed_stft`` (128/64 and 512/128)
            and ``packed_convolve`` (129 taps) on 256 segments of the
            serve campaign's Pareto lengths, against float64 oracles
            and the unpacked calls; the guard's host cost (each entry
            against its unguarded core and the bare kernel wrapper, in
            turns, and the guard's pieces on the host clock).  The
            main, reference, dsp, autotune, serve (but its triad),
            fleet and times phases must record no fault: no
            ``fault_*`` counter, ``fault_policy`` event, fault record or
            failed breaker;
4e. autotune — the measured autotuner (``VELES_SIMD_AUTOTUNE=on`` in
            this thread, a private tune cache in a temporary
            directory, the default CUDA-event probe timer) at the main
            path's geometries: the headline, 512 x 16384 x 129 and the
            short rows 3 x 5000 x 256, 70,000 x 8 x 256 and
            1 x 2^20 x 300 (``convolve.direct`` and, where the handle
            admits them, ``convolve.os``), ``stft`` 2^20 at 512/128,
            ``istft`` 64 x 16384, ``convolve2d`` 16 x 512^2 7 x 7, the
            DWT 512 x 4096 daub8, ``matrix_multiply`` 2048^3,
            ``hilbert`` at 1024 and 65536 and ``morlet_cwt`` 8 x 4096
            with 32 scales; one ``autotune:`` line each (family, tune
            key, static prior, winner, each route's probe us; a
            candidate whose probe failed, or a probe error, retry or
            inconclusive round, fails the phase), the
            winner held to its float64 oracle (1e-4 of max|y|, a
            ``*_bf16_comp`` winner to ``ERROR_BUDGETS["bf16_comp"]``);
            then the same calls as cache hits (no probe, no launch but
            the winner's kernel), the pack reloaded ``readonly`` (the
            same winners, zero probes), the pack restamped
            ``TPU v5 lite`` (every lookup a miss, ``device_mismatch``
            counted, the static priors), a CPU operand (never probed or
            stored under the card's stamp) and ``off`` bit-identical
            with and without the pack;
4f. pipeline — the pipeline compiler at full size, two chains:
            bench.py's ``sensor_bench`` (medfilt 5, linear detrend,
            sosfilt of butterworth(4, (0.044, 0.056), "bandstop"),
            stft 256/64, power; one stream, 24 blocks of 2048, held to
            ``oracle`` at bench.py's 1e-3) and ``matched_stft``
            (matched_filter of a 2047-tap template, stft 512/128,
            power; 64 streams x 16,384-sample blocks, 8 blocks, held at
            1e-4).  Each: its routes, one CUDA graph captured (and its
            seconds), one ``pipeline.dispatch`` span a block, fused
            equal to ``fused=False`` within 1e-6 of max|y|, blocks/s
            and p99 host-clock latency a block (each block synced) and
            device busy ms and kernels a block (``utils.devtrace``),
            fused and unfused, its ``("pipeline", name)`` resource row;
            no fault on the healthy replays; under
            ``pipeline.dispatch:device_lost:1`` with no retry exactly
            one host block degrades to the oracle and the stream stays
            within its tolerance; a host block on block 2, whose
            carried state is on the card, retries and re-raises under
            ``pipeline.dispatch:device_lost:9999`` with no oracle; the
            fused and unfused busy times agree within a factor of
            ``PL_BUSY_FACTOR`` (windows retried);
4g. serve — the serving loop (``serve.Server``, workers 2): bench
            config 11 (bench.py:780-828), 160 requests of loadgen's mix
            (tools/loadgen.py:96-106, rebuilt here with numpy), three
            tenants, flat-out arrivals, ``max_batch`` 8, 2 ms
            ``max_wait``, a warm pass then a timed one, against the
            same requests through the single-call ops (each synced):
            req/s, ``serve.request_latency`` p50/p99 an op, batches,
            padding rows, goodput, no csrc kernel; the STFT acceptance
            class (64 requests of 16,384 samples at 512/128), K4's
            launches equal to the batches, req/s, p50/p99, device busy
            ms a batch; ragged packing (``VELES_SIMD_SERVE_RAGGED=1``,
            stft 128/64 and 512/128 at Pareto lengths); a served
            ``matched_stft`` pipeline (64 streams x 8 blocks of 16,384,
            state threaded through the answers) captured under the
            server while plain ``sosfilt`` traffic runs on the second
            worker, equal to ``process`` on the same blocks within
            1e-6, one graph a row class; every answer within its
            float64 tolerance (IIR and resampling 2e-5, STFT 1e-4),
            every trace closed by one terminal edge with phases summing
            to the total within 1e-3 s, none answered twice, no fault
            on the healthy steps; then the resilience triad (deadlines,
            a poisoned class's breaker, DEGRADED and probed recovery,
            answers equal to the oracle) and the scrape endpoint
            (``/metrics``, ``/healthz``, ``/debug/requests``,
            ``/signals`` stamped ``veles-simd-signals-v4``,
            ``EndpointUnavailable`` on a taken port);
4h. fleet — the serving fleet (``serve.ReplicaGroup`` behind
            ``serve.FrontRouter``) at the JAX replica campaign's
            geometry (``tools/chaos.py:596-609``): 3 replicas,
            ``max_batch`` 32, 150 ms ``max_wait``, workers 2, heartbeat
            40 ms, fleet tick 25 ms, an aggregation endpoint on port 0,
            the ``matched_stft`` pipeline passed as ``pipeline_specs=``;
            waves of bench config 11's mix, the K4 class (16,384
            samples at 512/128) and one pipeline block a stream (8
            streams, state carried across waves), in thread mode and
            over the RPC data plane in subprocess mode: a timed
            K4-class wave on 3 replicas (req/s, p50, beside one server
            at the campaign's and at the serve phase's knobs), r0
            killed mid-wave (a SIGKILL of the child in subprocess
            mode), r1 drained mid-wave, r0 restarted.  Every answer
            within its float64 tolerance, the pipeline equal to
            ``process`` within 1e-6, none lost or answered twice, every
            trace closed, a failover with its deadline carried, a
            stitched fleet trace over 2 replicas or more, ``/healthz``
            200 throughout, r0 non-healthy in ``obs.signals()`` within
            60 collector ticks; in thread mode ``LAUNCHES["stft"]``
            equal to the K4-class batches summed over the replicas and
            the pipeline's graphs captured beside the other replicas'
            batches, in subprocess mode each live child's ``/metrics``
            carrying the ``resource_*{op="cuda",route="stft"}`` row and
            the pipeline's, each child's spawn-to-ready seconds and
            the card memory the children take; then the scaler
            (``tools/chaos.py:1260-1266``'s control settings): bursts
            of the mix until a ``scale_up``, idle until a
            ``scale_down``, none lost;
4i. parallel — the sharded families (``veles.simd_tpu_torch.parallel``)
            on an 8-shard mesh of ``cuda:0`` (the JAX tests' 8-device
            mesh) at the JAX package's users' sizes: ``sharded_convolve``
            1,048,576 x 2047 and its ring at 262,145 taps (``sp8``),
            ``sharded_convolve_batch`` 64 x 262,144 x 129 and
            ``sharded_convolve2d`` 16 x 512^2 7 x 7 (``dp2xsp4``), the
            all-to-all 2D DWT and its inverse on 4096^2 daub8 (K2 in
            the shards), the SWT and its inverse on 2^20 (3 levels),
            ``sharded_stft`` 2^20 at 512/128 and 8 x 65,536 at
            8192/2048, ``sharded_rfft`` 2^18 (the static pick, then the
            matmul route forced), ``sharded_sosfilt`` 8 x 2^20,
            ``sharded_matmul`` 2048^3 (``tp8``): each against a float64
            oracle at its JAX test's tolerance, its launches, chained
            and busy ms beside the single-card op at the same size;
            every other public function once at the JAX tests' sizes;
            a CUDA operand on a CPU mesh and the reverse refused;
            ``mesh_degrade`` 0 and every ``parallel.dispatch`` breaker
            closed; then ``parallel.sharded_matmul:device_lost`` forced:
            the call degrades to the single-card twin, still equals
            ``a @ b``, and the breaker re-closes once the plan clears;
5. times  — the headline convolve call (CUDA events, device-resident
            operands; and host clock from NumPy operands), the
            handle's own cuFFT overlap-save route beside it, the DWT,
            the fused cascade against the level loop, convolve2d, and
            ``stft`` (auto and forced routes) and ``batched_stft``;
            the breakdowns (``convolve_simd`` and ``convolve2d`` must
            run no pad or flip kernel, the fused cascade nothing but
            K3); the ``k-sweep`` line, K2's two
            variants at 512 x 16384 for 4..256 taps in turns; then each
            kernel, its plain version and its library yardstick (cuDNN
            ``conv1d``/``conv2d`` in fp32, ``torch.stft``) at the
            main-path shapes, as device time per call from CUPTI's
            records (``utils.devtrace``; the longest of three windows;
            the kernel also as chained CUDA events), beside the fp32
            bound (each counts the function's least work,
            ``utils.benchmark.conv_work``/``conv2d_work``/``stft_work``,
            so the bytes set them), which neither the kernel nor the
            library may beat;
            printed as one ``{"kernels": [...]}`` line;
6. cabi  — after the measurements of 5, the C ABI: the port's bridge
            (``veles/simd_tpu_torch/cabi/``) built with gcc,
            ``csrc/test_veles_simd.c`` and ``examples/c_matched_filter.c``
            compiled unchanged against it and run side by side with no
            ``VELES_SIMD_PLATFORM`` (all 17 families, 0 failures, a
            ``backend:`` line naming the card; the example's peak
            agreeing); then the bridge loaded with ctypes in this
            process (the shim runs in this interpreter) and the C
            entries that reach the kernels called through C on NumPy
            buffers: the convolution handle at 1,048,576 x 2047 (auto;
            K1 twice), ``stft`` 2^20 at 512/128 (K4 once),
            ``convolve2d`` 512^2 7 x 7 (K5 once), ``wavelet_apply2d``
            512^2 daub8 (K2 twice: rows, then the stacked columns),
            counters reset before each call and read after, each within
            1e-4 of float64, with its host ms beside the same call made
            from Python (result in host memory).  Without gcc,
            ``python3-config`` or Python's headers the phase prints one
            line saying so and nothing else;
7. artifacts — the warm pack: the library this process loaded packed
            in a private ``on`` store (``runtime/artifacts.py``); a
            fresh process with an empty build root
            (``VELES_SIMD_CACHE_DIR``) and ``VELES_SIMD_ARTIFACTS=
            readonly`` starts a ``serve.Server`` (preload 1 loaded),
            runs the headline with only a library cache hit (no nvcc)
            and K1's 2 launches within 1e-4 of float64, its seconds
            from spawn to result printed, the store unchanged after;
            the MANIFEST's device stamp doctored, a fresh process (side
            by side with the first) loads 0, counts ``artifact_stale``,
            places nothing and loads no library; the cold figure is
            this run's ``build:`` line when it was a cache miss
            (``tools/cold_start_torch.py`` times cold and warm serving
            processes in turns, each alone);
8. bench — ``bench_torch.py``'s configs 4 (the headline, K1 twice a
            call), 5 (the DWT, K2) and 6 (the STFT routes at 16k x
            512/64 and 1M x 512/128, K4) through their functions, each
            after its own check against the oracle, each row finite
            (one ``bench:`` line a row, with the card), then
            ``tools/tpu_smoke_torch.run_smoke()`` over every family
            (one ``bench smoke:`` line a family); any family that
            fails, or a fault on any of it, fails the phase.
9. suite — ``tools/benchmark_suite_torch.py``'s sections through their
            functions: the rows that reach a kernel at the JAX tool's
            full sizes (convolve 1M x 2047 and its precision=high row,
            K1; batched 256 x 4096 x 129 and the DWT orders, K2; the
            L3 cascade fused row, K3; stft 2^20 at 1024/256, K4 where
            its route is ``cuda_fused``; the 2D rows, K5), the rest at
            ``--quick`` sizes; each row held to its NumPy oracle before
            it is timed, one ``suite [...]`` line a row (chained
            Msamples/s, busy ms, launches); the phase fails unless K1,
            K2, K3 and K5 launched (and K4 where routed).
9b. examples — each of ``examples/*_torch.py`` (the JAX examples'
            twins) through its ``run()`` at the JAX example's sizes:
            every check held (the matched filter's pulse at 424242,
            both resonances, the template at (55, 215), the SNR gain,
            the round trips, the zoom pair, the Kaiser spec, the sharded
            spot checks), K5 launched by the image filter (the other
            examples reach no kernel: the matched filter's stream stage
            is the block matmul, the rest run single rows under K2's
            row gate); one ``examples <name>:``
            line each (checks, wall seconds, busy ms a block where the
            example streams, the launches of K1-K5), after the
            example's own lines; no fault recorded;
9c. tools — ``tools/bench_multichip_torch.py --quick`` on 8 shards of
            ``cuda:0`` (each row held to ``np.fft`` before it is timed;
            the mesh's cost on one card), ``tools/tune_conv2d_torch.py
            --quick`` (every candidate held to float64; the 2D kernel
            launched once and held in each cell its gate admits; the
            winner table and the area cut) and
            ``tools/profile_overlap_save_torch.py`` at 1,048,576 x 2047
            (every route held to float64, K1 twice a call, each route's
            busy ms and share of the least-work bound); no fault
            recorded.
9d. train — ``graft_entry_torch.py`` (the twin of
            ``__graft_entry__.py``): ``entry()``'s forward (8 x 4096,
            129 taps, 64 features) within 1e-4 of max|feats| of a
            float64 CPU run, its peak mask exact wherever both
            neighbour differences clear 1e-5 of max|filt| (the bits
            under it counted); ten ``train_step``s at that width, each
            loss and update within 1e-4 of a float64 CPU autograd step
            from the same parameters, the loss lower after them; one
            ``sharded_train_step`` on 8 shards of ``cuda:0`` (dp 2, sp
            2, tp 2) within 1e-5 of the single-card step;
            ``dryrun_multichip(8)`` with every check; busy ms a step
            (CUPTI), chained ms a step (CUDA events), the idle share,
            kernels a step, and K1-K5 launches of the step (none: the
            filter is cuFFT, the GEMM an fp32 matmul); no fault
            recorded.
10. chaos — ``tools/chaos_torch.py``'s four campaigns in-process at the
            JAX tool's default sizes: the single server (the mesh 8
            shards of the card), the replicas as threads, the replicas
            as subprocess children (the kill a SIGKILL of a child on
            the card) and the scale ramp; one ``chaos <campaign>:``
            line each (held/total invariants, its rows, its seconds);
            any invariant that does not hold fails the phase.  Past
            ``CHAOS_SMOKE_AFTER_S`` of the run the subprocess and scale
            campaigns run at ``--smoke``.

The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PARITY_TOL = 1e-5        # kernel vs plain, relative to max|plain|
ORACLE_TOL = 1e-4        # vs float64 oracle (tools/tpu_smoke.py's bound)
N_HEAD, K_HEAD = 1 << 20, 2047          # the bench headline
ROWS_FB, N_FB, K_FB = 512, 16384, 129   # batched direct convolution
K_PARITY = (1, 2, 3, 8, 16, 33, 129, 255, 256)   # K2 parity taps
K_SWEEP = (4, 8, 16, 33, 64, 129, 160, 192, 256)  # K2 variant sweep
ROWS_WV, N_WV, LEVELS = 512, 4096, 3    # BASELINE config 5: daub8 DWT
IMGS_2D, N_2D, K_2D = 16, 512, 7        # batched 2D convolution
N_ST, L_ST, HOP_ST = 1 << 20, 512, 128  # STFT acceptance (bench.py:640)
ROWS_BS, N_BS = 64, 16384               # bench configs 7-8 (bench.py:684)
ROWS_CWT, N_CWT, SCALES_CWT = 8, 4096, 32
STFT_TRIP_TOL = 1e-3     # istft(stft(x)) interior (bench.py:699-701)
CASCADE_TOL = 5e-4       # fused vs level loop (tests/test_pallas.py)
ROUND_TRIP_TOL = 2e-4    # DWT round trip (test_wavelet_synthesis.py)
# the reference phase: BASELINE configs 1-3 (bench.py:107-177, 380-400)
N_EL = 4096                              # config 1: 4096 x 4096 step
N_CPX, ROWS_SUM, N_SUM = 1 << 23, 64, 1 << 18
N_MF = 1 << 20                           # config 2: 1M floats
N_GEMM, N_GEMM2 = 512, 2048              # config 3, and the route GEMM
N_PLANES, N_PLANE, N_MINMAX = 64, 1024, 1 << 24
N_PEAKS = 1 << 20
# the dsp phase: tools/benchmark_suite.py:411-508 and bench.py:805-840
N_RS, UP_RS, DOWN_RS = 1 << 20, 160, 147   # 48 k -> 44.1 k
ROWS_BRS, N_BRS = 256, 4096
STREAM_BLOCK = 2048
IIR_TOL = 2e-5           # of max|y| (tests/test_iir.py)
RESAMPLE_TOL = 2e-5      # tests/test_resample.py
FOURIER_TOL = 1e-4
# the pipeline phase: bench.py's sensor_bench (bench.py:830-897), and the
# matched filter and STFT of the main path on bench configs 7-8's rows
PL_BLOCK, PL_BLOCKS, PL_BENCH_TOL = 2048, 24, 1e-3
PL_BLOCKS2 = 8
FUSED_TOL = 1e-6         # fused vs fused=False, of max|y|
# the same kernels run fused and unfused: their busy times a block
# agree within this factor (the fused step adds copies in and out of
# its static buffers); a profiled window that comes back short retries
PL_BUSY_FACTOR, PL_BUSY_WINDOWS = 1.5, 4
# the serve phase: tools/loadgen.py:96-106 and bench.py:780-828
SERVE_TENANTS = ("alice", "bob", "carol")
SERVE_REQUESTS, SERVE_K4_REQUESTS = 160, 64
SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS = 8, 2.0
SERVE_TRACE_TOL = 1e-3   # phases vs total (tools/loadgen.py TRACE_TOL_S)
SERVE_RAGGED = 48        # ragged requests a geometry
SERVE_PL_BLOCKS = 8      # served pipeline blocks, ROWS_BS streams each
# the fleet phase: the JAX replica campaign (tools/chaos.py:596-609) and
# its scaler ramp (tools/chaos.py:1260-1266)
FLEET_REPLICAS, FLEET_MAX_BATCH, FLEET_MAX_WAIT_MS = 3, 32, 150.0
FLEET_HEARTBEAT_MS, FLEET_TICK_MS = 40.0, 25.0
FLEET_MIX, FLEET_K4, FLEET_STREAMS = 96, 48, 8   # one traffic wave
FLEET_TIMED_K4 = 192     # the timed K4-class wave
FLEET_VISIBLE_TICKS = 60  # r0 non-healthy in obs.signals() within
FLEET_DEADLINE_MS = 60000.0
FLEET_RESOURCE = 'op="cuda",route="stft"'
# the parallel phase: the JAX tests' 8-device mesh (conftest.py,
# tools/bench_multichip.py) as 8 shards of cuda:0, at the JAX package's
# users' sizes: the ring's taps put k - 1 past the 163,840-sample block
PAR_SHARDS = 8
K_RING = 262145
ROWS_PB, N_PB = 64, 262144
N_PW = 4096
N_SWT = 1 << 20
ROWS_PST, N_PST, L_PST, HOP_PST = 8, 65536, 8192, 2048
N_PRF = 1 << 18
ROWS_PSOS, N_PSOS = 8, 1 << 20
# chained calls a timing, and profiled calls a window: a sharded call
# runs hundreds of kernels, so one window of 3 reads it; the
# single-card op runs one to a few, whose windows can lose kernels or
# come back empty late in the process, so it takes 20 a window and the
# longest of 3 windows (utils.benchmark's default)
PAR_ITERS, PAR_CALLS, PAR_SINGLE_CALLS = 3, 3, 20
# the train phase: graft_entry_torch.py's steps at entry()'s width; the
# peak mask is exact wherever both neighbour differences clear this
# share of max|filt| (cuFFT and the CPU's FFT round differently)
TRAIN_STEPS = 10
TRAIN_MASK_MARGIN = 1e-5
DAUB8_LO = np.array([-0.010597401784997278, 0.032883011666982945,
                     0.030841381835986965, -0.18703481171888114,
                     -0.02798376941698385, 0.6308807679295904,
                     0.7148465705525415, 0.23037781330885523])


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(np.all(np.isfinite(got)), "non-finite output")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def crel_err(got, want):
    """Relative error of a complex (or real) result against its
    float64 oracle, relative to max|want|."""
    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(np.all(np.isfinite(got)), "non-finite output")
    return float(np.max(np.abs(got.astype(np.complex128) - want))
                 / np.max(np.abs(want)))


def fft_conv64(x, h):
    """float64 full convolution of every row of x with h."""
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), m, axis=-1)
            * np.fft.rfft(h.astype(np.float64), m))
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1]


def conv2d64(x, h):
    """float64 full 2D convolution of every image of x with h."""
    m = (x.shape[-2] + h.shape[0] - 1, x.shape[-1] + h.shape[1] - 1)
    spec = (np.fft.rfft2(x.astype(np.float64), m)
            * np.fft.rfft2(h.astype(np.float64), m))
    return np.fft.irfft2(spec, m)


def ulp_err(got, want64):
    """Largest error of a float32 result in units in the last place of
    the float32 rounding of its float64 reference."""
    want32 = want64.astype(np.float32)
    return float(np.max(np.abs(got.astype(np.float64) - want64)
                        / np.spacing(np.abs(want32))))


def reference(torch, rng, bm, obs, ck, smi):
    """The reference-header surface on the card through its entry
    points (BASELINE configs 1-3, then normalize, peaks and filters):
    each op held to a float64 NumPy oracle, then timed.  None of these
    ops reaches a kernel of csrc/: the launch counters stay 0."""
    from veles.simd_tpu_torch.ops import arithmetic as ar
    from veles.simd_tpu_torch.ops import detect_peaks as dp
    from veles.simd_tpu_torch.ops import filters as fl
    from veles.simd_tpu_torch.ops import mathfun as mf
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.ops import normalize as nz
    from veles.simd_tpu_torch.runtime import precision as prx

    dev = torch.device("cuda")
    hbm_gbps = bm.H100_HBM_TBPS * 1e3
    ck.reset_launches()

    def rates(ms, elems, nbytes):
        return (f"{ms:.4f} ms = {elems / ms / 1e3:.1f} Melem/s, "
                f"{nbytes / ms / 1e6:.1f} GB/s "
                f"({nbytes / ms / 1e6 / hbm_gbps:.3f} of {hbm_gbps:.0f})")

    def timed(fn, elems, nbytes):
        # chained CUDA events: the call's device time
        return rates(bm.device_time_ms(fn, iters=20), elems, nbytes)

    def host_timed(fn, elems, nbytes):
        # the call ends on the host (NumPy results): host clock
        return rates(bm.host_time(fn, repeats=3) * 1e3, elems, nbytes)

    # arithmetic (BASELINE config 1): bench.py's 4096 x 4096 step
    i16 = rng.randint(-3000, 3000, (N_EL, N_EL)).astype(np.int16)
    b_el = rng.randn(N_EL, N_EL).astype(np.float32)
    i16_t = torch.as_tensor(i16, device=dev)
    b_t = torch.as_tensor(b_el, device=dev)

    def step():
        f = ar.int16_to_float(i16_t)
        return ar.float_to_int16(ar.add_to_all(ar.real_multiply(f, b_t),
                                               0.5))

    want_step = ar.float_to_int16_na(ar.add_to_all_na(
        ar.real_multiply_array_na(ar.int16_to_float_na(i16), b_el), 0.5))
    check(np.array_equal(step().cpu().numpy(), want_step),
          "config 1 step differs from its oracle")
    za = rng.randn(2 * N_CPX).astype(np.float32)
    zb = rng.randn(2 * N_CPX).astype(np.float32)
    za_t, zb_t = torch.as_tensor(za, device=dev), torch.as_tensor(
        zb, device=dev)
    cm = {}
    for name, fn in (("complex_multiply", ar.complex_multiply),
                     ("complex_multiply_conjugate",
                      ar.complex_multiply_conjugate)):
        z64 = za[0::2] + 1j * za[1::2].astype(np.float64)
        w64 = zb[0::2] + 1j * zb[1::2].astype(np.float64)
        if name.endswith("conjugate"):
            w64 = np.conj(w64)
        want = (z64 * w64).view(np.float64)
        cm[name] = rel_err(fn(za_t, zb_t).cpu().numpy(), want)
        check(cm[name] <= 1e-6, f"{name} rel err {cm[name]:.3e}")
    s_el = rng.rand(ROWS_SUM, N_SUM).astype(np.float32)
    s_t = torch.as_tensor(s_el, device=dev)
    err_sum = rel_err(ar.sum_elements(s_t).cpu().numpy(),
                      s_el.astype(np.float64).sum(-1))
    check(err_sum <= 1e-5, f"sum_elements rel err {err_sum:.3e}")
    sat = np.array([3e9, -3e9, np.nan, 0.9, -0.9, 2.0 ** 31], np.float32)
    got_sat = ar.float_to_int32(sat).cpu().numpy()
    check(np.array_equal(got_sat, [2 ** 31 - 1, -2 ** 31, 0, 0, 0,
                                   2 ** 31 - 1]),
          f"float_to_int32 {got_sat}")
    el = N_EL * N_EL
    print(f"reference arithmetic: config 1 step {N_EL}x{N_EL} "
          f"(int16_to_float, real_multiply, add_to_all, float_to_int16) "
          f"exact, " + timed(step, el, 8.0 * el)
          + f" | complex_multiply {N_CPX} pairs rel "
          f"{cm['complex_multiply']:.2e}, "
          + timed(lambda: ar.complex_multiply(za_t, zb_t), N_CPX,
                  24.0 * N_CPX)
          + f" | conjugate rel {cm['complex_multiply_conjugate']:.2e}, "
          + timed(lambda: ar.complex_multiply_conjugate(za_t, zb_t),
                  N_CPX, 24.0 * N_CPX)
          + f" | sum_elements {ROWS_SUM}x{N_SUM} rel {err_sum:.2e}, "
          + timed(lambda: ar.sum_elements(s_t), ROWS_SUM * N_SUM,
                  4.0 * ROWS_SUM * (N_SUM + 1))
          + f" | float_to_int32 [3e9, -3e9, nan, 0.9, -0.9, 2^31] -> "
          f"{got_sat.tolist()} | GB/s count each input read once and "
          f"each output written once | card {smi}")

    # mathfun (BASELINE config 2): 1M floats drawn as bench.py draws them
    x_mf = np.abs(rng.randn(N_MF).astype(np.float32)) + 0.1
    e_mf = ((rng.rand(N_MF) - 0.5) * 4.0).astype(np.float32)
    x_t = torch.as_tensor(x_mf, device=dev)
    e_t = torch.as_tensor(e_mf, device=dev)
    x64 = x_mf.astype(np.float64)
    funcs = (
        ("sin", lambda: mf.sin_psv(x_t), np.sin(x64), 1e-5, 1e-6),
        ("cos", lambda: mf.cos_psv(x_t), np.cos(x64), 1e-5, 1e-6),
        ("log", lambda: mf.log_psv(x_t), np.log(x64), 1e-4, 1e-4),
        ("exp", lambda: mf.exp_psv(x_t), np.exp(x64), 1e-5, 1e-6),
        ("pow", lambda: mf.pow_psv(x_t, e_t), np.power(x64, e_mf), 2e-5,
         0.0),
        ("sqrt", lambda: mf.sqrt_psv(x_t), np.sqrt(x64), 1e-6, 0.0))
    parts = []
    for name, fn, want, rtol, atol in funcs:
        got = fn().cpu().numpy().astype(np.float64)
        bad = np.abs(got - want) > atol + rtol * np.abs(want)
        check(not bad.any(), f"{name}_psv outside rtol {rtol} atol {atol}")
        nbytes = 4.0 * N_MF * (3 if name == "pow" else 2)
        parts.append(f"{name} {ulp_err(got, want):.2f} ulp, "
                     + timed(fn, N_MF, nbytes))
    u = rng.uniform(0.1, 5.0, N_MF).astype(np.float32)
    log_ulp = ulp_err(mf.log_psv(torch.as_tensor(u, device=dev))
                      .cpu().numpy(), np.log(u.astype(np.float64)))
    special = np.array([1e-40, -1e-40, 0.0, -0.0, -1.0, np.nan, np.inf],
                       np.float32)
    got_sp = mf.log_psv(special).cpu().numpy()
    want_sp = np.array([-np.inf] * 4 + [np.nan, np.nan, np.inf],
                       np.float32)
    check(np.array_equal(got_sp, want_sp, equal_nan=True),
          f"log_psv special values {got_sp}")
    print(f"reference mathfun: config 2, {N_MF} floats |x|+0.1 (max ulp "
          "vs float64): " + " | ".join(parts)
          + f" | log_psv on U[0.1, 5] max {log_ulp:.2f} ulp | log_psv "
          f"[1e-40, -1e-40, 0, -0, -1, nan, inf] -> {got_sp.tolist()}")

    # matrix (BASELINE config 3): sgemm 512 + gemv, then 2048 by route
    a5 = rng.randn(N_GEMM, N_GEMM).astype(np.float32)
    b5 = rng.randn(N_GEMM, N_GEMM).astype(np.float32)
    v5 = rng.randn(N_GEMM).astype(np.float32)
    a5_t, b5_t, v5_t = (torch.as_tensor(a, device=dev)
                        for a in (a5, b5, v5))
    a64, b64 = a5.astype(np.float64), b5.astype(np.float64)
    calls = (
        ("matrix_multiply", lambda: mx.matrix_multiply(a5_t, b5_t),
         a64 @ b64, bm.gemm_work(N_GEMM, N_GEMM, N_GEMM)),
        ("matrix_multiply_transposed",
         lambda: mx.matrix_multiply_transposed(a5_t, b5_t),
         a64 @ b64.T, bm.gemm_work(N_GEMM, N_GEMM, N_GEMM)),
        ("matrix_vector_multiply",
         lambda: mx.matrix_vector_multiply(a5_t, v5_t),
         a64 @ v5.astype(np.float64), bm.gemm_work(N_GEMM, N_GEMM, 1)))
    parts = []
    for name, fn, want, (flops, nbytes) in calls:
        err = rel_err(fn().cpu().numpy(), want)
        check(err <= PARITY_TOL, f"{name} rel err {err:.3e}")
        ms = bm.device_busy_ms(fn, calls=20)
        bound_ms, by = bm.gemm_bound(flops, nbytes, "highest")
        parts.append(f"{name} {N_GEMM} rel {err:.2e} {ms:.4f} ms "
                     f"{flops / ms / 1e6:.1f} GFLOP/s, {bound_ms / ms:.3f} "
                     f"of its bound ({by})")
    obs.reset()
    mx.matrix_multiply(a5_t, b5_t)
    engine = [e for e in obs.events()
              if e["op"] == "matrix_precision_route"]
    check(len(engine) == 1 and engine[0]["decision"] == "fp32"
          and not engine[0]["forced"], f"engine default {engine}")
    print("reference matrix: config 3, device time per call (profiled): "
          + " | ".join(parts) + " | engine default route fp32")

    a2 = rng.randn(N_GEMM2, N_GEMM2).astype(np.float32)
    b2 = rng.randn(N_GEMM2, N_GEMM2).astype(np.float32)
    a2_t, b2_t = (torch.as_tensor(a, device=dev) for a in (a2, b2))
    want2 = a2.astype(np.float64) @ b2.astype(np.float64)
    flops2, bytes2 = bm.gemm_work(N_GEMM2, N_GEMM2, N_GEMM2)
    routes = (("fp32", "highest"), ("bf16_comp", "bf16_comp"),
              ("int8", "int8"), ("bf16", "bf16"), ("default", "default"))
    os.environ[prx.INT8_ENV] = "1"
    try:
        obs.reset()
        mx.matrix_multiply(a2_t, b2_t)
        picked = [e["decision"] for e in obs.events()
                  if e["op"] == "matrix_precision_route"]
        check(picked == ["fp32"], f"engine pick under {prx.INT8_ENV}: "
              f"{picked}")
        rows, errs = [], {}
        for route, precision in routes:
            if route == "default":
                # not a matrix.gemm route: the layer's TF32 knob
                def fn(p=precision):
                    return prx.p_matmul(a2_t, b2_t, p)
            else:
                def fn(r=route):
                    return mx.matrix_multiply(a2_t, b2_t, precision=r)
            errs[route] = rel_err(fn().cpu().numpy(), want2)
            busy = bm.device_busy_ms(fn, calls=10)
            chained = bm.device_time_ms(fn, iters=10)
            names = [n[:64] for n in bm.device_kernels(fn, calls=2)]
            bound_ms, by = bm.gemm_bound(flops2, bytes2, precision)
            rows.append((route, precision, busy, chained, bound_ms, by,
                         names))
    finally:
        del os.environ[prx.INT8_ENV]
    print(f"reference matrix routes: matrix_multiply {N_GEMM2}^3, rel err "
          "vs float64 (budget), device ms per call profiled / chained, "
          "GFLOP/s, share of the route's bound: " + " | ".join(
              f"{route} rel {errs[route]:.2e} "
              f"({prx.ERROR_BUDGETS[precision]:.0e}) {busy:.4f} / "
              f"{chained:.4f} ms {flops2 / busy / 1e6:.1f} GFLOP/s "
              f"{bound_ms / busy:.3f} of {bound_ms:.4f} ms ({by}) "
              f"kernels {names}"
              for route, precision, busy, chained, bound_ms, by, names
              in rows) + f" | card {smi}")
    print(f"breakdown gemm {N_GEMM2} bf16_comp (device us per call): "
          + bm.device_breakdown(lambda: mx.matrix_multiply(
              a2_t, b2_t, precision="bf16_comp"), calls=5))
    for route, precision, *_ in rows:
        check(errs[route] <= prx.ERROR_BUDGETS[precision],
              f"{route} rel err {errs[route]:.3e} over its budget "
              f"{prx.ERROR_BUDGETS[precision]}")
    fp32_names = rows[0][-1]
    check(fp32_names and not any("tf32" in n.lower() for n in fp32_names),
          f"the fp32 route ran a TF32 kernel: {fp32_names}")

    # normalize: 64 u8 planes of 1024 x 1024, one constant
    planes = rng.randint(0, 256, (N_PLANES, N_PLANE, N_PLANE))
    planes = planes.astype(np.uint8)
    planes[5] = 77
    p_t = torch.as_tensor(planes, device=dev)
    got_n = nz.normalize2D(p_t).cpu().numpy()
    mn = planes.min(axis=(1, 2)).astype(np.float64)[:, None, None]
    mxv = planes.max(axis=(1, 2)).astype(np.float64)[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        want_n = np.where(mxv == mn, 0.0,
                          (planes - mn) / ((mxv - mn) / 2.0) - 1.0)
    err_n = float(np.max(np.abs(got_n - want_n)))
    check(err_n <= 1e-6 and not got_n[5].any(),
          f"normalize2D max abs err {err_n:.3e}")
    f1 = rng.randn(N_MINMAX).astype(np.float32)
    f1_t = torch.as_tensor(f1, device=dev)
    lo, hi = nz.minmax1D(f1_t)
    check(lo.item() == f1.min() and hi.item() == f1.max(), "minmax1D")
    n_pix = N_PLANES * N_PLANE * N_PLANE
    print(f"reference normalize: normalize2D {N_PLANES}x{N_PLANE}x"
          f"{N_PLANE} u8 (plane 5 constant -> zeros) max abs err "
          f"{err_n:.2e}, " + timed(lambda: nz.normalize2D(p_t), n_pix,
                                   5.0 * n_pix)
          + f" | minmax1D {N_MINMAX} floats exact, "
          + timed(lambda: nz.minmax1D(f1_t), N_MINMAX, 4.0 * N_MINMAX))

    # peaks: a noisy multi-tone of 2^20 samples
    t_pk = np.arange(N_PEAKS)
    x_pk = (np.sin(2 * np.pi * t_pk / 4096.0)
            + 0.5 * np.sin(2 * np.pi * t_pk / 97.0)
            + 0.1 * rng.randn(N_PEAKS)).astype(np.float32)
    xp_t = torch.as_tensor(x_pk, device=dev)
    pos, vals = dp.detect_peaks(xp_t)
    want_pos, want_vals = dp.detect_peaks_na(x_pk)
    check(np.array_equal(pos, want_pos) and np.array_equal(vals, want_vals),
          "detect_peaks differs from its oracle")
    cap = N_PEAKS // 8      # the top-k compaction route
    fpos, fvals, fcount = dp.detect_peaks_fixed(xp_t, max_peaks=cap)
    k = min(int(fcount), cap)
    check(int(fcount) == len(want_pos)
          and np.array_equal(fpos[:k].cpu().numpy(), want_pos[:k])
          and np.array_equal(fvals[:k].cpu().numpy(), want_vals[:k]),
          "detect_peaks_fixed differs from its oracle")
    # find_peaks' float64 oracle at this size: the maxima of the
    # detect_peaks oracle, SciPy's prominences and bases (compiled; the
    # same outward walk and tie rule as the port's oracle, whose Python
    # walk takes tens of seconds here), the port's width oracle on the
    # kept peaks, and find_peaks' two conditions in its order
    from scipy import signal as ss

    kw = dict(prominence=0.5, width=3.0)
    peaks, props = dp.find_peaks(xp_t, **kw)
    raw = want_pos[x_pk[want_pos] > x_pk[want_pos - 1]]
    prom64, lbase, rbase = ss.peak_prominences(x_pk.astype(np.float64),
                                               raw)
    prom = prom64.astype(np.float32)
    keep = prom >= kw["prominence"]
    raw, prom, lbase, rbase = raw[keep], prom[keep], lbase[keep], \
        rbase[keep]
    widths = dp.peak_widths_na(x_pk, raw, 0.5, prom=prom)
    keep = widths[0] >= kw["width"]
    want_props = {"prominences": prom[keep], "left_bases": lbase[keep],
                  "right_bases": rbase[keep]}
    want_props.update(zip(("widths", "width_heights", "left_ips",
                           "right_ips"), (w[keep] for w in widths)))
    check(np.array_equal(peaks, raw[keep]), "find_peaks positions")
    for key in ("prominences", "left_bases", "right_bases"):
        check(np.array_equal(props[key], want_props[key]),
              f"find_peaks {key} differ from the oracle")
    err_w = max(rel_err(props[key], want_props[key])
                for key in ("widths", "width_heights", "left_ips",
                            "right_ips"))
    check(err_w <= PARITY_TOL, f"find_peaks widths rel err {err_w:.3e}")
    print(f"reference peaks: {N_PEAKS} samples, detect_peaks "
          f"{len(pos)} extrema exact, "
          + host_timed(lambda: dp.detect_peaks(xp_t), N_PEAKS,
                       4.0 * N_PEAKS)
          + f" (host clock) | detect_peaks_fixed max_peaks {cap} (top-k) "
          "exact, "
          + timed(lambda: dp.detect_peaks_fixed(xp_t, max_peaks=cap),
                  N_PEAKS, 4.0 * N_PEAKS)
          + f" | find_peaks {kw} {len(peaks)} peaks, positions, "
          f"prominences and bases exact, widths rel {err_w:.2e}, "
          + host_timed(lambda: dp.find_peaks(xp_t, **kw), N_PEAKS,
                       4.0 * N_PEAKS) + " (host clock)")

    # filters: 64 x 16384 rows, 16 planes of 512 x 512
    x_fl = rng.randn(ROWS_BS, N_BS).astype(np.float32)
    xf_t = torch.as_tensor(x_fl, device=dev)
    img = rng.randn(IMGS_2D, N_2D, N_2D).astype(np.float32)
    img_t = torch.as_tensor(img, device=dev)
    filt = (
        ("medfilt k=5", lambda: fl.medfilt(xf_t, 5),
         fl.medfilt_na(x_fl, 5), 0.0, ROWS_BS * N_BS),
        ("savgol_filter 31/3", lambda: fl.savgol_filter(xf_t, 31, 3),
         fl.savgol_filter_na(x_fl, 31, 3), PARITY_TOL, ROWS_BS * N_BS),
        ("wiener", lambda: fl.wiener(xf_t), fl.wiener_na(x_fl),
         PARITY_TOL, ROWS_BS * N_BS),
        ("medfilt2d 3x3", lambda: fl.medfilt2d(img_t, 3),
         fl.medfilt2d_na(img, 3), 0.0, IMGS_2D * N_2D * N_2D))
    parts = []
    for name, fn, want, tol, elems in filt:
        err = rel_err(fn().cpu().numpy(), want)
        check(err <= tol, f"{name} rel err {err:.3e} > {tol}")
        parts.append(f"{name} rel {err:.2e}, "
                     + timed(fn, elems, 8.0 * elems))
    print(f"reference filters: {ROWS_BS}x{N_BS} rows and "
          f"{IMGS_2D}x{N_2D}x{N_2D} planes vs float64 oracles: "
          + " | ".join(parts))
    torch.cuda.synchronize()
    check(not any(ck.LAUNCHES.values()),
          f"the reference path launched a csrc kernel: {ck.LAUNCHES}")


def resample64(x, up, down, taps):
    """float64 ``resample_poly`` oracle in polyphase form (SciPy's
    compiled ``upfirdn``), for sizes where the textbook oracle's
    zero-stuffed signal (n * up samples) is too large: the centered
    grid ``full[pad + i * down]`` is ``upfirdn`` of the signal behind
    ``z`` zeros, from output ``j0``, with ``pad + z * up = j0 * down``
    (up and down coprime)."""
    from scipy import signal as ss

    k, n = len(taps), x.shape[-1]
    pad = (k - 1) // 2
    out_len = -(-n * up // down)
    z = next(z for z in range(down) if (pad + z * up) % down == 0)
    j0 = (pad + z * up) // down
    xz = np.concatenate([np.zeros(x.shape[:-1] + (z,)),
                         x.astype(np.float64)], axis=-1)
    y = ss.upfirdn(taps, xz, up, down, axis=-1)[..., j0:j0 + out_len]
    out = np.zeros(x.shape[:-1] + (out_len,))
    out[..., :y.shape[-1]] = y
    return out


def dsp(torch, rng, bm, ck, smi):
    """The IIR and resampling families on the card through their entry
    points, each held to a float64 oracle and timed; they reach no
    kernel of csrc/ (torch ops: the doubling scan's fp32 multiply-adds,
    cuDNN ``conv1d`` pinned to fp32, cuFFT)."""
    from veles.simd_tpu_torch.ops import batched as bt
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.ops import resample as rs

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    ck.reset_launches()

    def cuda(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def measure(name, fn, want, tol, n_in, n_out, extra=""):
        got = fn()
        torch.cuda.synchronize()
        err = rel_err(got.cpu().numpy(), want)
        check(err <= tol, f"dsp {name} rel err {err:.3e} > {tol}")
        chained = bm.device_time_ms(fn, iters=20)
        busy, launches = bm.device_profile(fn, calls=10)
        nbytes = 4.0 * (n_in + n_out)
        bound = nbytes / (bm.H100_HBM_TBPS * 1e9)
        print(f"dsp {name}: rel {err:.2e} (tol {tol:.0e}) | "
              f"{chained:.4f} ms chained = "
              f"{n_in / chained / 1e3:.1f} Msamples/s | device busy "
              f"{busy:.4f} ms, {launches:.0f} kernels a call | bound "
              f"{bound:.6f} ms ({nbytes / 1e6:.1f} MB read and written "
              f"once) = {bound / busy:.3f} of busy{extra}")
        return launches

    # the float64 polyphase oracle against the textbook one first
    x_small = rng.randn(2, 1000)
    taps_rs = rs._resample_taps(UP_RS, DOWN_RS, None)
    gap = rel_err(resample64(x_small, UP_RS, DOWN_RS, taps_rs),
                  rs.resample_poly_na(x_small, UP_RS, DOWN_RS))
    check(gap <= 1e-12, f"the upfirdn oracle differs by {gap:.3e}")

    # IIR: 64 x 16384 rows (tools/benchmark_suite.py), one row too
    butter = iir.butterworth(4, 0.25)
    cheby = iir.cheby1(8, 0.05, 0.2)
    b_lf, a_lf = [0.2, 0.3, 0.1], [1.0, -0.5, 0.2, -0.05]
    x_ii = rng.randn(ROWS_BS, N_BS).astype(np.float32)
    x_t = cuda(x_ii)
    x1_t = x_t[:1].contiguous()
    n_ii = ROWS_BS * N_BS
    want_butter = iir.sosfilt_na(butter, x_ii)
    want_ff = iir.sosfiltfilt_na(cheby, x_ii)
    per_section = measure(
        f"sosfilt butterworth(4, 0.25) {ROWS_BS}x{N_BS}",
        lambda: iir.sosfilt(butter, x_t), want_butter, IIR_TOL, n_ii, n_ii,
        f" | {len(butter)} sections, levels "
        + str([iir._doubling_powers(iir._companion((1.0, r[4], r[5])),
                                    (N_BS - 1).bit_length()).shape[0]
               for r in butter])) / len(butter)
    print(f"dsp scan: {per_section:.1f} kernels a section (sosfilt "
          f"{ROWS_BS}x{N_BS}) | breakdown (device us per call): "
          + bm.device_breakdown(lambda: iir.sosfilt(butter, x_t), calls=5))
    measure(f"sosfilt butterworth(4, 0.25) 1x{N_BS}",
            lambda: iir.sosfilt(butter, x1_t), want_butter[:1], IIR_TOL,
            N_BS, N_BS)
    measure(f"batched_sosfilt butterworth(4, 0.25) {ROWS_BS}x{N_BS}",
            lambda: bt.batched_sosfilt(butter, x_t), want_butter, IIR_TOL,
            n_ii, n_ii)
    measure(f"batched_sosfilt butterworth(4, 0.25) 1x{N_BS}",
            lambda: bt.batched_sosfilt(butter, x1_t), want_butter[:1],
            IIR_TOL, N_BS, N_BS)
    measure(f"sosfiltfilt cheby1(8, 0.05, 0.2) {ROWS_BS}x{N_BS}",
            lambda: iir.sosfiltfilt(cheby, x_t), want_ff, IIR_TOL, n_ii,
            n_ii)
    measure(f"decimate iir factor 4 {ROWS_BS}x{N_BS}",
            lambda: rs.decimate(x_t, 4, ftype="iir"), want_ff[..., ::4],
            IIR_TOL, n_ii, n_ii // 4)
    measure(f"batched_lfilter order 3 {ROWS_BS}x{N_BS}",
            lambda: bt.batched_lfilter(b_lf, a_lf, x_t),
            iir.lfilter_na(b_lf, a_lf, x_ii), IIR_TOL, n_ii, n_ii)
    one_shot = iir.sosfilt(butter, x_t)

    def stream():
        st = iir.StreamingSosfilt(butter)
        return torch.cat([st.process(c)
                          for c in x_t.split(STREAM_BLOCK, dim=-1)], -1)

    gap = rel_err(stream().cpu().numpy(), one_shot.cpu().numpy())
    check(gap <= IIR_TOL, f"streaming vs one-shot {gap:.3e}")
    measure(f"StreamingSosfilt {N_BS // STREAM_BLOCK} blocks of "
            f"{STREAM_BLOCK} x {ROWS_BS} rows", stream, want_butter,
            IIR_TOL, n_ii, n_ii, f" | vs one-shot {gap:.2e}")

    # resampling: 2^20 samples at 160/147, 256 x 4096 batched
    x_rs = rng.randn(N_RS).astype(np.float32)
    xr_t = cuda(x_rs)
    out_rs = rs.resample_length(N_RS, UP_RS, DOWN_RS)
    k_rs = len(taps_rs)
    n_phase, _, runs = rs._polyphase_runs(taps_rs, UP_RS, DOWN_RS,
                                          k_rs - 1 - (k_rs - 1) // 2)
    macs = sum(w.size for _, w in runs) * -(-out_rs // n_phase)
    measure(f"resample_poly {UP_RS}/{DOWN_RS} {N_RS} ({k_rs} taps)",
            lambda: rs.resample_poly(xr_t, UP_RS, DOWN_RS),
            resample64(x_rs, UP_RS, DOWN_RS, taps_rs), RESAMPLE_TOL, N_RS,
            out_rs, f" | {len(runs)} conv1d runs, {macs / 1e6:.1f} M "
            f"multiply-adds (out_len * ceil(k/up) = "
            f"{out_rs * -(-k_rs // UP_RS) / 1e6:.1f} M)")
    names = bm.device_kernels(lambda: rs.resample_poly(xr_t, UP_RS,
                                                       DOWN_RS), calls=2)
    names += bm.device_kernels(lambda: iir.sosfilt(butter, x_t), calls=2)
    check(not any("tf32" in n.lower() for n in names),
          f"a TF32 kernel in the scan or the polyphase core: {names}")
    print("dsp breakdown resample_poly (device us per call): "
          + bm.device_breakdown(lambda: rs.resample_poly(
              xr_t, UP_RS, DOWN_RS), calls=5))
    x_brs = rng.randn(ROWS_BRS, N_BRS).astype(np.float32)
    xb_t = cuda(x_brs)
    measure(f"batched_resample_poly {UP_RS}/{DOWN_RS} "
            f"{ROWS_BRS}x{N_BRS}",
            lambda: bt.batched_resample_poly(xb_t, UP_RS, DOWN_RS),
            resample64(x_brs, UP_RS, DOWN_RS, taps_rs), RESAMPLE_TOL,
            ROWS_BRS * N_BRS,
            ROWS_BRS * rs.resample_length(N_BRS, UP_RS, DOWN_RS))
    measure(f"decimate fir factor 4 {N_RS}",
            lambda: rs.decimate(xr_t, 4),
            resample64(x_rs, 1, 4, rs._resample_taps(1, 4, None)),
            RESAMPLE_TOL, N_RS, N_RS // 4)
    measure(f"resample_fourier {N_RS} -> {out_rs}",
            lambda: rs.resample_fourier(xr_t, out_rs),
            rs.resample_fourier_na(x_rs, out_rs), FOURIER_TOL, N_RS,
            out_rs)
    torch.cuda.synchronize()
    check(not any(ck.LAUNCHES.values()),
          f"the dsp path launched a csrc kernel: {ck.LAUNCHES}")
    print(f"dsp: card {smi} | no csrc kernel, no TF32 kernel | phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def healthy(phase, obs, faults, breaker):
    """Fail when a phase that runs no fault plan recorded a fault: a
    ``fault_*`` counter or ``fault_policy`` event since the last
    ``obs.reset()``, a retained fault record (retries, demotions and
    exhaustions since the engine's last reset, whatever ``obs`` did),
    a breaker that ever failed or is not closed, or an armed plan."""
    snap = obs.snapshot()
    bad = ([c["name"] for c in snap["counters"]
            if c["name"].startswith("fault_")]
           + [e["decision"] for e in snap["events"]
              if e["op"] == "fault_policy"]
           + [r["action"] + "@" + r["site"] for r in faults.fault_history()]
           + [b["site"] for b in breaker.snapshot()
              if b["state"] != breaker.CLOSED or b["failures"]])
    check(not bad and not faults.plan_snapshot()
          and faults.FAULT_PLAN_ENV not in os.environ,
          f"{phase}: the healthy path recorded faults {bad[:8]}")
    return len(breaker.snapshot())


def pareto_lengths(rng, count, lo, hi):
    """The serve campaign's heavy-tailed request lengths
    (tools/loadgen.py:588-623): ``lo * (1 + Pareto(1.5))`` clipped to
    ``[lo, hi]``."""
    return [max(lo, min(int(lo * (1.0 + rng.pareto(1.5))), hi))
            for _ in range(count)]


def faults_phase(torch, rng, bm, ck, obs, smi):
    """The fault policy on the card through the entry points, at full
    size, with injected plans (backoff 0): each kernel route's
    demotion (no launch, the answer from the fallback route within
    1e-4 of the float64 oracle, the next call skipping the kernel),
    the dispatch guard's retry answered by K1, a breaker opened by
    exhausted retries on host input that short-circuits to the oracle
    and recloses once the plan clears, operands already on the card
    (no oracle, no demotion: the fault re-raises); then the ragged
    segment packing
    of the serve campaign's lengths; then the guard's host cost."""
    from veles.simd_tpu_torch.ops import batched as bt
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import segments as seg
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.runtime import breaker, faults

    t_phase = time.perf_counter()
    os.environ[faults.FAULT_BACKOFF_ENV] = "0"
    dev = torch.device("cuda")
    obs.enable()
    sync = torch.cuda.synchronize

    def cuda(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def host(y):
        return y.cpu().numpy() if isinstance(y, torch.Tensor) else y

    def start(plan):
        # each scenario on a clean engine: no fault records, no breakers
        obs.reset()
        faults.reset_fault_history()
        ck.reset_launches()
        faults.set_fault_plan(plan)

    # the headline's kernel route refused once: demoted, remembered
    x_head = rng.randn(N_HEAD).astype(np.float32)
    h_head = rng.randn(K_HEAD).astype(np.float32)
    want_head = fft_conv64(x_head, h_head)
    handle = cv.convolve_initialize(N_HEAD, K_HEAD)
    start("convolve.os_cuda:vmem_oom:1")
    os_launches, os_err = [], []
    for _ in range(2):
        ck.reset_launches()
        y = cv.convolve(handle, x_head, h_head)
        sync()
        os_launches.append(ck.LAUNCHES["overlap_save"])
        os_err.append(rel_err(host(y), want_head))
    faults.set_fault_plan(None)
    routes = [e["decision"] for e in obs.events()
              if e["op"] == "convolve_os_route"]
    check(obs.counter_value("cuda_os_demotion", reason="compile_oom") == 1
          and obs.counter_value("fault_demotion",
                                site="convolve.os_cuda") == 1
          and K_HEAD in cv._CUDA_OS_REJECTED,
          "the headline's kernel route did not demote and remember")
    check(os_launches == [0, 0] and routes == ["xla_matmul"] * 2,
          f"demoted headline launches {os_launches}, routes {routes}")
    check(max(os_err) <= ORACLE_TOL, f"demoted headline rel err {os_err}")
    cv._CUDA_OS_REJECTED.discard(K_HEAD)
    print(f"faults: convolve {N_HEAD}x{K_HEAD} convolve.os_cuda:vmem_oom:1"
          f" demoted 1 (cuda_os_demotion), overlap_save launches "
          f"{os_launches}, routes {routes}, rel {max(os_err):.2e}")

    # the dispatch guard: two device losses retried, K1 answers
    start("convolve.dispatch:device_lost:2")
    y = cv.convolve(handle, x_head, h_head)
    sync()
    faults.set_fault_plan(None)
    retry_launches = ck.LAUNCHES["overlap_save"]
    err_retry = rel_err(host(y), want_head)
    check(isinstance(y, torch.Tensor) and y.is_cuda
          and retry_launches == 2
          and obs.counter_value("fault_retry",
                                site="convolve.dispatch") == 2
          and err_retry <= ORACLE_TOL,
          f"retried headline: launches {retry_launches}, rel "
          f"{err_retry:.3e}")
    print(f"faults: convolve.dispatch:device_lost:2 retried 2, answered "
          f"by K1 (overlap_save launches {retry_launches}), rel "
          f"{err_retry:.2e}")

    # the STFT kernel route refused once
    x_st = rng.randn(N_ST).astype(np.float32)
    want_st = sp.stft_na(x_st, L_ST, HOP_ST)
    start("spectral.stft_cuda:vmem_oom:1")
    st_launches, st_err = [], []
    for _ in range(2):
        ck.reset_launches()
        y = sp.stft(x_st, L_ST, HOP_ST)
        sync()
        st_launches.append(ck.LAUNCHES["stft"])
        st_err.append(crel_err(host(y), want_st))
    faults.set_fault_plan(None)
    st_routes = [(e["decision"], e.get("demoted_from"))
                 for e in obs.events() if e["op"] == "stft_route"]
    check(obs.counter_value("cuda_stft_demotion",
                            reason="compile_oom") == 1
          and (L_ST, HOP_ST) in sp._CUDA_STFT_REJECTED
          and st_launches == [0, 0] and max(st_err) <= ORACLE_TOL
          and st_routes == [("cuda_fused", None),
                            ("rdft_matmul", "cuda_fused"),
                            ("rdft_matmul", None)],
          f"stft demotion: launches {st_launches}, routes {st_routes}, "
          f"rel {st_err}")
    sp._CUDA_STFT_REJECTED.discard((L_ST, HOP_ST))
    print(f"faults: stft {N_ST} {L_ST}/{HOP_ST} spectral.stft_cuda:"
          f"vmem_oom:1 demoted 1 (cuda_stft_demotion) to rdft_matmul, "
          f"stft launches {st_launches}, rel {max(st_err):.2e}")

    # the 2D kernel route refused once
    x_2d = rng.randn(IMGS_2D, N_2D, N_2D).astype(np.float32)
    h_2d = rng.randn(K_2D, K_2D).astype(np.float32)
    want_2d = conv2d64(x_2d, h_2d)
    key_2d = (IMGS_2D, N_2D, N_2D, K_2D, K_2D)
    start("convolve2d.direct_cuda:vmem_oom:1")
    c2_launches, c2_err = [], []
    for _ in range(2):
        ck.reset_launches()
        y = cv2.convolve2d(x_2d, h_2d)
        sync()
        c2_launches.append(ck.LAUNCHES["filter_2d"])
        c2_err.append(rel_err(host(y), want_2d))
    faults.set_fault_plan(None)
    c2_routes = [e["decision"] for e in obs.events()
                 if e["op"] == "convolve2d"]
    check(obs.counter_value("cuda2d_demotion", reason="compile_oom") == 1
          and key_2d in cv2._CUDA2D_REJECTED and c2_launches == [0, 0]
          and c2_routes == ["fft", "fft"] and max(c2_err) <= ORACLE_TOL,
          f"convolve2d demotion: launches {c2_launches}, routes "
          f"{c2_routes}, rel {c2_err}")
    cv2._CUDA2D_REJECTED.discard(key_2d)
    print(f"faults: convolve2d {IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D} "
          f"convolve2d.direct_cuda:vmem_oom:1 demoted 1 (cuda2d_demotion)"
          f" to fft, filter_2d launches {c2_launches}, rel "
          f"{max(c2_err):.2e}")

    # a class whose dispatch keeps failing, on host input: two calls
    # exhaust their retries and degrade, the breaker opens, the third
    # short-circuits to the oracle; the plan cleared, the cadence's
    # probe recloses it and K1 answers again
    start("convolve.dispatch:device_lost:9999")
    br_err = []
    t0 = time.perf_counter()
    for _ in range(3):
        y = cv.convolve(handle, x_head, h_head)
        check(isinstance(y, np.ndarray), "a degraded answer is NumPy")
        br_err.append(rel_err(y, want_head))
    degraded_s = time.perf_counter() - t0
    faults.set_fault_plan(None)
    br = breaker.lookup("convolve.dispatch",
                        ("overlap_save", K_HEAD, N_HEAD))
    state_open = br.state
    counts = {name: obs.counter_value(name, site="convolve.dispatch")
              for name in ("fault_retry", "fault_breaker_short_circuit")}
    counts["fault_degraded"] = obs.counter_value(
        "fault_degraded", site="convolve.dispatch", to="oracle")
    check(state_open == breaker.OPEN and ck.LAUNCHES["overlap_save"] == 0
          and counts == {"fault_retry": 4,
                         "fault_breaker_short_circuit": 1,
                         "fault_degraded": 2}
          and max(br_err) <= ORACLE_TOL,
          f"breaker: state {state_open}, counters {counts}, launches "
          f"{ck.LAUNCHES['overlap_save']}, rel {br_err}")
    n_close = 0
    while br.state != breaker.CLOSED and n_close < 8:
        ck.reset_launches()
        y = cv.convolve(handle, x_head, h_head)
        sync()
        n_close += 1
    check(br.state == breaker.CLOSED and isinstance(y, torch.Tensor)
          and ck.LAUNCHES["overlap_save"] == 2
          and rel_err(host(y), want_head) <= ORACLE_TOL,
          f"breaker did not reclose: {br.info()}")
    print(f"faults: convolve.dispatch:device_lost:9999 on host input: 2 "
          f"calls degraded to the oracle, breaker {state_open}, 1 short-"
          f"circuit, counters {counts}, rel {max(br_err):.2e}, "
          f"{degraded_s * 1e3:.1f} ms host clock for the 3 calls | plan "
          f"cleared: closed after {n_close} calls, the last on K1 "
          f"(launches 2), breaker {br.info()}")
    faults.reset_fault_history()

    # operands already on the card get no oracle and no demotion: two
    # device losses retried, then the third re-raised with the fault
    # recorded; a refused kernel launch raises untouched, nothing
    # remembered, and the next call runs K1
    xc, hc = cuda(x_head), cuda(h_head)
    card = {}
    for plan in ("convolve.dispatch:device_lost:9999",
                 "convolve.os_cuda:vmem_oom:1"):
        start(plan)
        try:
            cv.convolve(handle, xc, hc)
            card[plan] = "answered"
        except faults.InjectedFault as e:
            card[plan] = "raised " + str(e).split(":")[0]
        faults.set_fault_plan(None)
        card[plan + " counts"] = (
            obs.counter_value("fault_retry", site="convolve.dispatch"),
            obs.counter_value("fault_exhausted", site="convolve.dispatch",
                              kind="device_lost"),
            obs.counter_value("fault_degraded", site="convolve.dispatch",
                              to="oracle"),
            obs.counter_value("fault_demotion", site="convolve.os_cuda"),
            ck.LAUNCHES["overlap_save"])
    ck.reset_launches()
    y = cv.convolve(handle, xc, hc)
    sync()
    err_card = rel_err(host(y), want_head)
    lost, refused = ("convolve.dispatch:device_lost:9999",
                     "convolve.os_cuda:vmem_oom:1")
    check(card[lost].startswith("raised")
          and card[lost + " counts"] == (2, 1, 0, 0, 0)
          and card[refused].startswith("raised")
          and card[refused + " counts"] == (0, 0, 0, 0, 0)
          and K_HEAD not in cv._CUDA_OS_REJECTED
          and ck.LAUNCHES["overlap_save"] == 2 and err_card <= ORACLE_TOL,
          f"card operands: {card}, then launches "
          f"{ck.LAUNCHES['overlap_save']}, rel {err_card:.3e}")
    print(f"faults: card operands: {lost} {card[lost]} (retry, exhausted, "
          f"degraded, demotion, launches {card[lost + ' counts']}); "
          f"{refused} {card[refused]} ({card[refused + ' counts']}), not "
          f"remembered; the next call on K1 (launches 2), rel "
          f"{err_card:.2e}")
    faults.reset_fault_history()

    # ragged segment packing: 256 segments of the serve campaign's
    # Pareto lengths, each against its float64 oracle and against the
    # unpacked per-segment call
    def pack_case(name, segs, packed, unpacked_one, oracle_one, kernel):
        ck.reset_launches()
        obs.reset()
        outs, degraded = packed()
        sync()
        launches = ck.LAUNCHES[kernel] if kernel else 0
        check(degraded == [False] * len(segs), f"{name} degraded")
        check(not faults.fault_history(), f"{name} recorded a fault")
        alone = [host(unpacked_one(s)) for s in segs]
        err = max(crel_err(o, oracle_one(s)) for o, s in zip(outs, segs))
        diff = max(float(np.max(np.abs(o - a)) / np.max(np.abs(a)))
                   for o, a in zip(outs, alone))
        equal = sum(bool(np.array_equal(o, a)) for o, a in zip(outs, alone))
        packed_ms = bm.host_time(packed, repeats=3) * 1e3

        def loop():
            for s in segs:
                host(unpacked_one(s))

        loop_ms = bm.host_time(loop, repeats=3) * 1e3
        return launches, err, diff, equal, packed_ms, loop_ms

    seg_lines = []
    for name, lo, hi, L, hop in (("stft", 128, 2800, 128, 64),
                                 ("stft", 512, 16384, 512, 128)):
        segs = [rng.randn(n).astype(np.float32)
                for n in pareto_lengths(rng, 256, lo, hi)]
        # the K4 case packs into rows of the longest length, so every
        # packed row holds enough frames for the kernel's gate
        width = hi if hop % 128 == 0 else None
        strides = [seg.stft_stride(s.shape[0], hop) for s in segs]
        width, rows, _ = seg.plan_pack(strides, width)
        res = pack_case(
            name, segs,
            lambda: seg.packed_stft(segs, L, hop, width=width),
            lambda s: bt.batched_stft(s[None, :], L, hop)[0],
            lambda s: sp.stft_na(s, L, hop), "stft")
        check(res[1] <= ORACLE_TOL and res[2] <= ORACLE_TOL,
              f"packed_stft {L}/{hop}: rel {res[1]:.3e}, vs unpacked "
              f"{res[2]:.3e}")
        # K4 where the gate admits a packed row (128/64's rows of 4096
        # samples hold 63 frames, under its 64)
        k4 = sp._STFT_FAMILY.select(
            frame_length=L, hop=hop, frames=sp.frame_count(width, L, hop),
            cuda=True) == "cuda_fused"
        check((res[0] >= 1) == k4,
              f"packed_stft {L}/{hop} stft launches {res[0]}")
        seg_lines.append(
            f"packed_stft {L}/{hop} 256 segments {lo}-{hi} "
            f"(samples {sum(s.shape[0] for s in segs)}) -> {rows} x "
            f"{width}, stft launches {res[0]}, rel vs float64 "
            f"{res[1]:.2e}, max diff vs unpacked {res[2]:.2e} "
            f"({res[3]}/256 bit-equal), host clock {res[4]:.2f} ms "
            f"packed vs {res[5]:.2f} ms unpacked loop")
    segs = [rng.randn(n).astype(np.float32)
            for n in pareto_lengths(rng, 256, 128, 2800)]
    h_pk = rng.randn(K_FB).astype(np.float32)
    width, rows, _ = seg.plan_pack(
        [seg.convolve_stride(s.shape[0], K_FB) for s in segs])
    res = pack_case(
        "convolve", segs, lambda: seg.packed_convolve(segs, h_pk),
        lambda s: cv.convolve_simd(s, h_pk),
        lambda s: fft_conv64(s, h_pk), "filter_bank")
    check(res[0] >= 1 and res[1] <= ORACLE_TOL and res[2] <= 1e-5,
          f"packed_convolve: fb launches {res[0]}, rel {res[1]:.3e}, vs "
          f"unpacked {res[2]:.3e}")
    seg_lines.append(
        f"packed_convolve {K_FB} taps 256 segments 128-2800 (samples "
        f"{sum(s.shape[0] for s in segs)}) -> {rows} x {width}, "
        f"filter_bank launches {res[0]}, rel vs float64 {res[1]:.2e}, "
        f"max diff vs unpacked {res[2]:.2e} ({res[3]}/256 bit-equal), "
        f"host clock {res[4]:.2f} ms packed vs {res[5]:.2f} ms unpacked "
        "loop")
    for line in seg_lines:
        print("segments: " + line)

    # the guard's host cost: each entry point against the unguarded
    # core it calls and the bare kernel wrapper, operands on the card,
    # telemetry off, in turns; the device work is the same kernels
    obs.disable()
    xh, th = cuda(x_head), cuda(h_head)
    xst = cuda(x_st)
    win_np = sp.hann_window(L_ST)
    win = cuda(win_np)
    x2, h2 = cuda(x_2d), cuda(h_2d)
    levels = {
        "convolve": (lambda: cv.convolve(handle, xh, th),
                     lambda: cv._run_torch(handle, xh, th),
                     lambda: cv._conv_os_cuda(xh, th)),
        "stft": (lambda: sp.stft(xst, L_ST, HOP_ST),
                 lambda: sp._run_stft_cuda(xst, win_np, L_ST, HOP_ST),
                 lambda: ck.stft_cuda(xst, win, L_ST, HOP_ST)),
        "convolve2d": (lambda: cv2.convolve2d(x2, h2),
                       lambda: cv2._run2d_torch(x2, h2, False, "direct",
                                                True, True, (0, 0)),
                       lambda: cv2._conv2d_direct_cuda(x2, h2)),
    }
    for name, (entry, core, bare) in levels.items():
        turns = []
        for label, fn in (("entry", entry), ("core", core), ("bare", bare),
                          ("bare", bare), ("core", core),
                          ("entry", entry)):
            turns.append((label, bm.device_time_ms(fn, iters=200)))
        mean = {lab: float(np.mean([ms for lab_, ms in turns
                                    if lab_ == lab]))
                for lab in ("entry", "core", "bare")}
        busy_entry, busy_bare = bm.device_busy_ms(entry), \
            bm.device_busy_ms(bare)
        k_entry, k_bare = (sorted(bm.device_kernels(entry)),
                           sorted(bm.device_kernels(bare)))
        check(k_entry == k_bare, f"guard {name}: the entry runs "
              f"{k_entry}, the bare wrapper {k_bare}")
        print(f"guard: {name} chained ms per call in turns "
              + " ".join(f"{lab} {ms:.4f}" for lab, ms in turns)
              + f" | entry - core {(mean['entry'] - mean['core']) * 1e3:.1f}"
              f" us, core - bare {(mean['core'] - mean['bare']) * 1e3:.1f}"
              f" us | device busy entry {busy_entry:.4f} ms, bare "
              f"{busy_bare:.4f} ms, same kernels {k_entry}")

    # the guard's pieces on the host clock (no plan, no card work)
    def per_call_us(fn, n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    noop = lambda: None  # noqa: E731
    rej = set()
    parts = {
        "inject": lambda: faults.inject("convolve.dispatch"),
        "armed": lambda: faults.armed("convolve.os_cuda"),
        "breaker_for+admit+success": lambda: (
            breaker.breaker_for("guard.cost", 1).admit(),
            breaker.breaker_for("guard.cost", 1).success()),
        "guarded": lambda: faults.guarded("guard.cost", noop),
        "breaker_guarded": lambda: faults.breaker_guarded(
            "guard.cost", 1, noop, fallback=noop),
        "demote_and_remember": lambda: faults.demote_and_remember(
            "guard.cost", noop, noop, cache=rej, key=1, route="a",
            fallback_route="b", counter="c"),
        "os route select": lambda: cv._OS_FAMILY.select(
            h_length=K_HEAD, cuda=xh.is_cuda),
    }
    print("guard parts: host-clock us per call (no plan): " + " | ".join(
        f"{k} {per_call_us(fn):.2f}" for k, fn in parts.items()))
    faults.reset_fault_history()
    obs.enable()
    obs.reset()
    del os.environ[faults.FAULT_BACKOFF_ENV]
    print(f"faults: phase {time.perf_counter() - t_phase:.1f} s | card "
          f"{smi}")


# the kernel counter each kernel route's dispatch bumps
KERNEL_OF_ROUTE = {("convolve.os", "cuda_fused"): "overlap_save",
                   ("convolve.direct", "direct_cuda"): "filter_bank",
                   ("wavelet", "cuda"): "filter_bank",
                   ("convolve2d", "direct"): "filter_2d",
                   ("stft", "cuda_fused"): "stft"}


def resources_line(torch, obs, calls):
    """``obs.resources()``'s ``("cuda", route)`` row of each main-path
    call, recorded afresh (``obs.reset()`` before each), its FLOPs and
    bytes equal to ``utils.benchmark``'s work at that shape and its
    attainable share of the roofline at most 100 %; one ``resources``
    line."""
    rows = []
    for route, call, (flops, nbytes) in calls:
        obs.reset()
        call()
        torch.cuda.synchronize()
        got = [r for r in obs.resources()
               if r["op"] == "cuda" and r["route"] == route]
        check(len(got) == 1, f"resources: {len(got)} ('cuda', {route!r}) "
              f"rows, want 1: {obs.resources()}")
        r = got[0]
        check(r["flops"] == flops and r["bytes_accessed"] == nbytes,
              f"resources {route}: flops {r['flops']} bytes "
              f"{r['bytes_accessed']} != utils.benchmark's {flops} "
              f"{nbytes} at {r['shapes']}")
        pct = r["attainable_pct_of_roofline"]
        check(pct is not None and 0.0 < pct <= 100.0,
              f"resources {route}: attainable {pct} %")
        rows.append({k: r[k] for k in (
            "route", "flops", "bytes_accessed", "arith_intensity",
            "attainable_pct_of_roofline", "peak_bytes")})
        # the cascade's plan tuples make its signature long
        rows[-1]["shapes"] = r["shapes"][:80]
    print("resources: " + json.dumps({"cuda": rows}))


# the F13 resource rows: one public op per family that the JAX package
# wraps as an instrumented core outside the kernels, at a user's size
# (64 x 16,384 float32 for the 1D families, 1024^2 for the gemm,
# 16 x 512^2 for 2D, 1024 angular frequencies for Lomb-Scargle), the
# (op, route) keys obs.resources() must hold after it, alone, and each
# row's work (the port's work= at that shape) as a literal formula of
# the sizes, or utils.benchmark's where it is that function;
# tests/test_torch_resources_parity.py runs this table on the CPU at
# small sizes
OPS_SIZES = {"rows": 64, "n": 1 << 14, "gemm": 1024, "imgs": 16,
             "side": 512, "freqs": 1024}
OPS_TAPS = 31           # resample_poly 3/2's taps
OPS_CONV_TAPS = 257     # the FFT convolution's taps
OPS_SOS = np.array([[0.0048243434, 0.0096486868, 0.0048243434, 1.0,
                     -1.0485995764, 0.2961403575],
                    [1.0, 2.0, 1.0, 1.0, -1.3209134308, 0.6327387929]])


def _ops_out_len(s):
    return -(-s["n"] * 3 // 2)


OPS_RESOURCE_ROWS = (
    ("arithmetic", lambda m, a: m.arithmetic.real_multiply(a["x"], a["x"]),
     ("real_multiply", "default"),
     lambda bm, s: (s["rows"] * s["n"], 12.0 * s["rows"] * s["n"])),
    ("mathfun", lambda m, a: m.mathfun.sin_psv(a["x"]),
     ("mathfun", "sin"),
     lambda bm, s: (s["rows"] * s["n"], 8.0 * s["rows"] * s["n"])),
    ("matrix", lambda m, a: m.matrix.matrix_multiply(a["ga"], a["gb"]),
     ("matrix", "gemm"),
     lambda bm, s: (2.0 * s["gemm"] ** 3, 12.0 * s["gemm"] ** 2)),
    ("normalize", lambda m, a: m.normalize.normalize2D(a["x"]),
     ("normalize2d", "default"),
     lambda bm, s: (4.0 * s["rows"] * s["n"], 8.0 * s["rows"] * s["n"])),
    ("detect_peaks",
     lambda m, a: m.detect_peaks.detect_peaks_fixed(
         a["x"], max_peaks=a["x"].shape[-1] // 16),
     ("peaks_fixed", "default"),
     lambda bm, s: (5.0 * s["rows"] * s["n"],
                4.0 * s["rows"] * s["n"]
                + (8.0 * (s["n"] // 16) + 4.0) * s["rows"])),
    ("filters", lambda m, a: m.filters.medfilt(a["x"], 5),
     ("rank_filter_xla", "default"),
     lambda bm, s: (5.0 * s["rows"] * s["n"], 8.0 * s["rows"] * s["n"])),
    ("iir", lambda m, a: m.iir.sosfilt(OPS_SOS, a["x"]),
     ("sosfilt_xla", "default"),
     lambda bm, s: (18.0 * s["rows"] * s["n"],
                8.0 * s["rows"] * s["n"] + 48.0)),
    ("resample",
     lambda m, a: m.resample.resample_poly(a["x"], 3, 2, taps=a["taps"]),
     ("resample_conv", "default"),
     lambda bm, s: (2.0 * s["rows"] * _ops_out_len(s) * -(-OPS_TAPS // 3),
                4.0 * (s["rows"] * s["n"] + OPS_TAPS
                       + s["rows"] * _ops_out_len(s)))),
    ("wavelet",
     lambda m, a: m.wavelet.wavelet_reconstruct(
         "daub", 8, a["x"][:, ::2], a["x"][:, 1::2]),
     ("dwt_synth", "default"),
     lambda bm, s: (16.0 * s["rows"] * s["n"],
                8.0 * s["rows"] * s["n"] + 64.0)),
    ("convolve",
     lambda m, a: m.convolve.convolve(m.convolve.convolve_initialize(
         a["x"].shape[-1], OPS_CONV_TAPS,
         m.convolve.ConvolutionAlgorithm.FFT), a["x"], a["h"]),
     ("convolve", "fft"),
     lambda bm, s: bm.conv_work(s["rows"], s["n"], OPS_CONV_TAPS)),
    ("convolve2d",
     lambda m, a: m.convolve2d.convolve2d(a["img"], a["h2"],
                                          algorithm="fft"),
     ("convolve2d", "fft"),
     lambda bm, s: bm.conv2d_work(s["imgs"], s["side"], s["side"], 5,
                                  5)),
    ("batched", lambda m, a: m.batched.batched_sosfilt(OPS_SOS, a["x"]),
     ("batched_sosfilt", "batched"),
     lambda bm, s: (18.0 * s["rows"] * s["n"],
                8.0 * s["rows"] * s["n"] + 48.0)),
    ("spectral",
     lambda m, a: m.spectral.lombscargle(a["t"], a["x"][0], a["freqs"]),
     ("lombscargle_xla", "default"),
     lambda bm, s: (20.0 * s["freqs"] * s["n"],
                4.0 * (3 * s["n"] + 2 * s["freqs"]))),
)


def ops_operands(torch, rng, dev, s):
    """The table's operands on ``dev``, float32, from ``rng``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    taps = np.hamming(OPS_TAPS) * np.sinc(
        (np.arange(OPS_TAPS) - OPS_TAPS // 2) / 3.0)
    return {"x": t(rng.randn(s["rows"], s["n"])),
            "ga": t(rng.randn(s["gemm"], s["gemm"])),
            "gb": t(rng.randn(s["gemm"], s["gemm"])),
            "h": t(rng.randn(OPS_CONV_TAPS)),
            "img": t(rng.randn(s["imgs"], s["side"], s["side"])),
            "h2": t(rng.randn(5, 5)),
            "taps": 3.0 * taps / taps.sum(),
            "t": np.sort(rng.rand(s["n"])) * s["n"] / 64.0,
            "freqs": np.linspace(0.5, 40.0, s["freqs"])}


def ops_resource_rows(torch, obs, bm, dev, rng, sizes=OPS_SIZES):
    """Each table row's op once on ``dev`` with telemetry on, after
    ``obs.reset()``: its outputs finite, ``obs.resources()`` exactly
    the row's key, carrying the row's work and at most 100 % of the
    roofline.  Returns the rows."""
    import importlib
    import types

    mods = types.SimpleNamespace(**{
        name: importlib.import_module(f"veles.simd_tpu_torch.ops.{name}")
        for name in (
            "arithmetic", "mathfun", "matrix", "normalize",
            "detect_peaks", "filters", "iir", "resample", "wavelet",
            "convolve", "convolve2d", "batched", "spectral")})
    a = ops_operands(torch, rng, dev, sizes)
    rows = []
    for family, call, key, want in OPS_RESOURCE_ROWS:
        obs.reset()
        out = call(mods, a)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for o in (out if isinstance(out, tuple) else (out,)):
            check(bool(torch.isfinite(torch.as_tensor(o)).all()),
                  f"resources ops {family}: non-finite output")
        got = obs.resources()
        keys = [(r["op"], r["route"]) for r in got]
        check(keys == [key], f"resources ops {family}: rows {keys}, "
              f"want [{key}]")
        flops, nbytes = (float(v) for v in want(bm, sizes))
        r = got[0]
        check(r["flops"] == flops and r["bytes_accessed"] == nbytes,
              f"resources ops {family}: flops {r['flops']} bytes "
              f"{r['bytes_accessed']} != {flops} {nbytes} at "
              f"{r['shapes'][:80]}")
        pct = r["attainable_pct_of_roofline"]
        check(pct is not None and 0.0 < pct <= 100.0,
              f"resources ops {family}: attainable {pct} %")
        rows.append({"family": family, "op": key[0], "route": key[1],
                     "flops": flops, "bytes_accessed": nbytes,
                     "attainable_pct_of_roofline": pct})
    return rows


def pipeline_phase(torch, rng, bm, obs, faults, breaker, ck, smi):
    """The pipeline compiler at full size: bench.py's ``sensor_bench``
    chain (1 stream, 24 blocks of 2048, held to its oracle at 1e-3) and
    the main path's matched filter (2047 taps) and STFT (512/128) on
    64 streams of 16,384-sample blocks (8 blocks, 1e-4).  Each captures
    one CUDA graph on its first block, runs one ``pipeline.dispatch``
    span a block, equals ``fused=False`` within 1e-6 of max|y|, records
    no fault on healthy replays, and under
    ``pipeline.dispatch:device_lost:1`` (no retries) degrades exactly
    one host block to the oracle and stays within tolerance."""
    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch.ops import iir

    t_phase = time.perf_counter()
    notch = iir.butterworth(4, (44 / 1000.0, 56 / 1000.0), "bandstop")
    template = rng.randn(K_HEAD).astype(np.float32)
    chains = (
        ("sensor_bench",
         lambda: [pl.medfilt(5), pl.detrend("linear"), pl.sosfilt(notch),
                  pl.stft(256, 64), pl.power()],
         PL_BLOCK, (), PL_BLOCKS, PL_BENCH_TOL),
        ("matched_stft",
         lambda: [pl.matched_filter(template), pl.stft(L_ST, HOP_ST),
                  pl.power()],
         N_BS, (ROWS_BS,), PL_BLOCKS2, ORACLE_TOL),
    )
    for name, stages, block, lead, n_blocks, tol in chains:
        cp = pl.Pipeline(stages(), name=name).compile(block)
        x = rng.randn(*lead, n_blocks * block).astype(np.float32)
        blocks = [x[..., i:i + block]
                  for i in range(0, n_blocks * block, block)]
        want = cp.oracle(x)

        # the fused stream: the first block captures the graph
        obs.reset()
        ck.reset_launches()
        got, _ = cp.stream(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        captures = [e for e in obs.events() if e["op"] == "pipeline_graph"]
        spans = [e for e in obs.trace_events()
                 if e.get("name") == "pipeline.dispatch"]
        check(cp.compile_cache_size() == 1 and len(captures) == 1,
              f"{name}: {cp.compile_cache_size()} graphs, "
              f"{len(captures)} captures, want 1")
        check(len(spans) == n_blocks, f"{name}: {len(spans)} "
              f"pipeline.dispatch spans for {n_blocks} blocks")
        err = rel_err(got, want)
        check(err <= tol, f"{name}: stream vs oracle rel err {err:.3e}")
        res = [r for r in obs.resources()
               if (r["op"], r["route"]) == ("pipeline", name)]
        check(len(res) == 1, f"{name}: resources {obs.resources()}")
        unfused, _ = cp.stream(x, fused=False)
        torch.cuda.synchronize()
        d_fu = float(np.max(np.abs(got - unfused)) / np.max(np.abs(got)))
        check(d_fu <= FUSED_TOL, f"{name}: fused vs fused=False "
              f"{d_fu:.3e}")

        # per-block host latency from host blocks, each block synced
        def block_times(fused):
            state = cp.init_state(lead)
            ts = []
            for b in blocks:
                t0 = time.perf_counter()
                _, state = cp.process(b, state, fused=fused)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            return np.asarray(ts)

        block_times(False)                  # warm the unfused path
        timing = {f: block_times(f) for f in (True, False)}
        _, st_dev = cp.process(blocks[0], cp.init_state(lead))
        for _ in range(PL_BUSY_WINDOWS):
            busy = {f: bm.device_profile(
                lambda f=f: cp.process(blocks[1], st_dev, fused=f),
                calls=10) for f in (True, False)}
            ratio = busy[True][0] / busy[False][0]
            if 1 / PL_BUSY_FACTOR <= ratio <= PL_BUSY_FACTOR:
                break
        check(1 / PL_BUSY_FACTOR <= ratio <= PL_BUSY_FACTOR,
              f"{name}: busy a block fused {busy[True][0]:.4f} ms against "
              f"unfused {busy[False][0]:.4f} ms in {PL_BUSY_WINDOWS} "
              f"windows, want within {PL_BUSY_FACTOR}x")
        n_breakers = healthy(f"pipeline {name}", obs, faults, breaker)

        # one device loss on a host block: that block alone degrades
        obs.reset()
        faults.reset_fault_history()
        os.environ[faults.FAULT_RETRIES_ENV] = "0"
        os.environ[faults.FAULT_BACKOFF_ENV] = "0"
        faults.set_fault_plan("pipeline.dispatch:device_lost:1")
        try:
            got_f, _ = cp.stream(x)
        finally:
            faults.set_fault_plan(None)
            del os.environ[faults.FAULT_RETRIES_ENV]
            del os.environ[faults.FAULT_BACKOFF_ENV]
        torch.cuda.synchronize()
        degraded = obs.counter_value("fault_degraded",
                                     site="pipeline.dispatch", to="oracle")
        check(degraded == 1, f"{name}: {degraded} blocks degraded, want 1")
        err_f = rel_err(got_f, want)
        check(err_f <= tol, f"{name}: degraded stream rel err {err_f:.3e}")
        faults.reset_fault_history()
        obs.reset()

        # a host block whose carried state is on the card (block 2):
        # no oracle, the default retries, then the fault re-raises
        state = cp.init_state(lead)
        for b in blocks[:2]:
            _, state = cp.process(b, state)
        def leaves(tree):
            return ([v for t in tree for v in leaves(t)]
                    if isinstance(tree, tuple) else [tree])

        check(faults.on_card(*leaves(state)),
              f"{name}: carried state not on the card after 2 blocks")
        os.environ[faults.FAULT_BACKOFF_ENV] = "0"
        faults.set_fault_plan("pipeline.dispatch:device_lost:9999")
        raised = False
        try:
            cp.process(blocks[2], state)
        except faults.InjectedFault:
            raised = True
        finally:
            faults.set_fault_plan(None)
            del os.environ[faults.FAULT_BACKOFF_ENV]
        counts = tuple(obs.counter_value(c, site="pipeline.dispatch", **kw)
                       for c, kw in (("fault_retry", {}),
                                     ("fault_degraded", {"to": "oracle"})))
        check(raised and counts == (2, 0), f"{name}: card state under "
              f"device_lost:9999 raised {raised}, (retries, degraded) "
              f"{counts}, want True, (2, 0)")
        faults.reset_fault_history()
        breaker.reset()
        obs.reset()

        r = res[0]
        print(f"pipeline {name}: {'x'.join(map(str, lead + (block,)))} "
              f"blocks x {n_blocks} | routes {cp.routes()} | graphs "
              f"{cp.compile_cache_size()} captured in "
              f"{captures[0]['seconds']:.3f} s | rel {err:.2e} (tol "
              f"{tol:g}) | fused vs unfused {d_fu:.2e} | one "
              f"pipeline.dispatch span a block | kernel launches "
              f"{launches or 0} | {n_breakers} breakers closed")
        print(f"pipeline {name} times (host clock, each block synced): " +
              " | ".join(
                  f"{'fused' if f else 'fused=False'} "
                  f"{n_blocks / ts.sum():.1f} blocks/s p99 "
                  f"{np.percentile(ts, 99) * 1e3:.3f} ms busy "
                  f"{busy[f][0]:.4f} ms {busy[f][1]:.0f} kernels a block"
                  for f, ts in timing.items()) + f" | card {smi}")
        print(f"pipeline {name} resources: " + json.dumps({k: r[k] for k in (
            "op", "route", "shapes", "argument_bytes", "output_bytes",
            "peak_bytes")}))
        print(f"pipeline {name} faults: pipeline.dispatch:device_lost:1 "
              f"(no retry) degraded {degraded} host block to the oracle, "
              f"stream rel {err_f:.2e} | block 2 with card state under "
              f"device_lost:9999: re-raised after {counts[0]} retries, "
              f"none degraded")
    print(f"pipeline: phase {time.perf_counter() - t_phase:.1f} s")


def serve_mix():
    """loadgen's traffic table (tools/loadgen.py:96-106): (op, params,
    lengths) — butterworth(4, 0.25) sosfilt, an order-2 lfilter,
    resample_poly 3/2 and stft 128/64 on short rows."""
    from veles.simd_tpu_torch.ops import iir

    return [
        ("sosfilt", {"sos": iir.butterworth(4, 0.25, "lowpass")},
         (384, 500, 777, 1024)),
        ("lfilter", {"b": [0.2, 0.3, 0.1], "a": [1.0, -0.4, 0.1]},
         (256, 640)),
        ("resample_poly", {"up": 3, "down": 2}, (300, 512)),
        ("stft", {"frame_length": 128, "hop": 64}, (512, 1000)),
    ]


def serve_schedule(rng, count):
    """``count`` requests of loadgen's mix with flat-out arrivals, drawn
    as ``tools/loadgen.build_schedule(rng, count, rate_hz=0)`` draws
    them: ``[(op, params, x, tenant), ...]``."""
    mix = serve_mix()
    out = []
    for _ in range(count):
        op, params, lengths = mix[rng.randint(len(mix))]
        n = int(lengths[rng.randint(len(lengths))])
        x = rng.randn(n).astype(np.float32)
        out.append((op, params, x,
                    SERVE_TENANTS[rng.randint(len(SERVE_TENANTS))]))
    return out


def serve_oracle(op, params, x):
    """The float64 answer of one request (the ops' NumPy oracles)."""
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.ops import resample as rs
    from veles.simd_tpu_torch.ops import spectral as sp

    if op == "sosfilt":
        return iir.sosfilt_na(params["sos"], x)
    if op == "lfilter":
        return iir.lfilter_na(params["b"], params["a"], x)
    if op == "resample_poly":
        return rs.resample_poly_na(x, params["up"], params["down"])
    return sp.stft_na(x, params["frame_length"], params["hop"])


SERVE_TOL = {"sosfilt": IIR_TOL, "lfilter": IIR_TOL,
             "resample_poly": RESAMPLE_TOL, "stft": ORACLE_TOL}


def served(srv, schedule, timeout=120.0):
    """Submit ``schedule`` flat out, wait for every ticket; returns
    ``(tickets, answers, seconds)`` (submit of the first to the answer
    of the last, host clock).  A request admission shed (a tenant past
    its queue bound: the server's typed answer, as loadgen counts it)
    answers None; one unanswered within ``timeout`` raises."""
    from veles.simd_tpu_torch import serve

    t0 = time.perf_counter()
    tickets = [srv.submit(serve.Request(op, x, params, tenant=tenant))
               for op, params, x, tenant in schedule]
    answers = []
    for t in tickets:
        try:
            answers.append(t.result(timeout=timeout))
        except serve.Overloaded:
            answers.append(None)
    return tickets, answers, time.perf_counter() - t0


def check_served(what, schedule, tickets, answers, obs, sheds=False):
    """Every answer ``ok`` and within its float64 tolerance (or, where
    ``sheds``, a typed admission shed), every trace closed by exactly
    one terminal edge with phases summing to the total, none answered
    twice; returns ``(worst error an op, sheds)``."""
    from veles.simd_tpu_torch.obs import requests as obs_requests

    terminal = set(obs_requests.TERMINAL_STATUSES.values())
    worst, shed = {}, 0
    for (op, params, x, _), t, y in zip(schedule, tickets, answers):
        if y is None and sheds and t.status == "shed":
            shed += 1
        else:
            check(t.status == "ok" and isinstance(y, np.ndarray),
                  f"{what}: {op} ticket {t.status}, answer {type(y)}")
            err = crel_err(y, serve_oracle(op, params, x))
            check(err <= SERVE_TOL[op], f"{what}: {op} n={x.size} rel "
                  f"err {err:.3e} > {SERVE_TOL[op]}")
            worst[op] = max(worst.get(op, 0.0), err)
        tr = t.trace
        ends = [e for e in tr.events() if e["event"] in terminal]
        p = tr.phases()
        drift = abs(p["queue_wait_s"] + p["batch_wait_s"] + p["device_s"]
                    - p["total_s"])
        check(tr.status == t.status and len(ends) == 1
              and drift <= SERVE_TRACE_TOL,
              f"{what}: trace {tr.rid} status {tr.status}, {len(ends)} "
              f"terminal edges, phase drift {drift:.2e}")
    check(obs.counter_value("serve_double_answer") == 0,
          f"{what}: a request was answered twice")
    return worst, shed


def latency_line(obs, ops, tickets):
    """p50/p99 of ``serve.request_latency`` an op (obs.quantiles: the
    histogram's bucket bounds) beside the exact ones of the traces."""
    parts = []
    for op in ops:
        q = obs.quantiles("serve.request_latency", op=op, status="ok")
        tot = np.asarray([t.trace.total_s for t in tickets
                          if t.op == op and t.status == "ok"]) * 1e3
        parts.append(f"{op} p50 {q['p50'] * 1e3:.3f} p99 "
                     f"{q['p99'] * 1e3:.3f} ms (buckets; traces "
                     f"{np.percentile(tot, 50):.3f} / "
                     f"{np.percentile(tot, 99):.3f} ms)")
    return " | ".join(parts)


def serve_phase(torch, rng, bm, obs, faults, breaker, ck, smi):
    """The serving loop on the card through ``serve.Server``: bench
    config 11's mix (bench.py:780-828) against the single-call ops; the
    STFT acceptance geometry, one K4 launch a batch; ragged packing;
    a served pipeline (one graph a row class, captured while plain
    traffic runs on a second worker); the resilience triad; the scrape
    endpoint."""
    import threading
    import urllib.error
    import urllib.request

    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.obs import http as obs_http
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.ops import resample as rs
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.serve import server as srv_mod

    t_phase = time.perf_counter()

    def new_server(**kw):
        kw.setdefault("max_batch", SERVE_MAX_BATCH)
        kw.setdefault("max_wait_ms", SERVE_MAX_WAIT_MS)
        kw.setdefault("workers", 2)
        return serve.Server(**kw)

    # 1. bench config 11: 160 requests of loadgen's mix, warm then timed
    schedule = serve_schedule(rng, SERVE_REQUESTS)
    single = {"sosfilt": lambda p, x: iir.sosfilt(p["sos"], x),
              "lfilter": lambda p, x: iir.lfilter(p["b"], p["a"], x),
              "resample_poly": lambda p, x: rs.resample_poly(
                  x, p["up"], p["down"]),
              "stft": lambda p, x: sp.stft(x, p["frame_length"],
                                           p["hop"])}

    def sequential():
        t0 = time.perf_counter()
        for op, params, x, _ in schedule:
            single[op](params, x).cpu()
        return time.perf_counter() - t0

    with new_server() as srv:
        served(srv, schedule)                        # warm
        sequential()
        obs.reset()
        ck.reset_launches()
        tickets, answers, wall = served(srv, schedule)
        launches = dict(ck.LAUNCHES)
        counts, good = srv.stats()["counts"], srv.goodput()["overall"]
    seq = sequential()
    worst, shed = check_served("serve mix", schedule, tickets, answers,
                               obs, sheds=True)
    answered = len(schedule) - shed
    check(not any(launches.values()), f"serve mix: the mix launched "
          f"csrc kernels {launches}")
    print(f"serve mix (bench config 11, {SERVE_REQUESTS} requests, 3 "
          f"tenants, max_batch {SERVE_MAX_BATCH}, max_wait "
          f"{SERVE_MAX_WAIT_MS} ms, workers 2): served "
          f"{answered / wall:.1f} req/s ({answered} answered, {shed} "
          f"shed by admission, {wall * 1e3:.1f} ms) | "
          f"sequential single calls, each synced "
          f"{SERVE_REQUESTS / seq:.1f} req/s ({seq * 1e3:.1f} ms) | "
          f"batches {counts['batches']}, padding rows "
          f"{counts['dispatched_rows'] - counts['useful_rows']}, goodput "
          f"rows {good['goodput']:.3f} samples "
          f"{good['sample_goodput']:.3f} | worst rel " + json.dumps(
              {k: float(f"{v:.2e}") for k, v in sorted(worst.items())})
          + " | no csrc kernel")
    print("serve mix latency: " + latency_line(
        obs, [m[0] for m in serve_mix()], tickets))
    healthy("serve mix", obs, faults, breaker)

    # 2. the kernel class: stft 512/128 on 16,384-sample rows, one K4
    # launch a device batch
    k4 = [("stft", {"frame_length": L_ST, "hop": HOP_ST},
           rng.randn(N_BS).astype(np.float32),
           SERVE_TENANTS[i % len(SERVE_TENANTS)])
          for i in range(SERVE_K4_REQUESTS)]
    with new_server() as srv:
        served(srv, k4)                              # warm
        obs.reset()
        ck.reset_launches()
        before = srv.stats()["counts"]["batches"]
        tickets, answers, wall = served(srv, k4)
        launches = dict(ck.LAUNCHES)
        batches = srv.stats()["counts"]["batches"] - before
        worst, _ = check_served("serve stft", k4, tickets, answers, obs)
        latency = latency_line(obs, ["stft"], tickets)
        others = {k: v for k, v in launches.items() if k != "stft" and v}
        check(launches["stft"] == batches and not others
              and batches >= SERVE_K4_REQUESTS // SERVE_MAX_BATCH,
              f"serve stft: launches {launches} for {batches} batches")
        healthy("serve stft", obs, faults, breaker)
        one_batch = k4[:SERVE_MAX_BATCH]
        busy, kernels = bm.device_profile(lambda: served(srv, one_batch),
                                          calls=5)
    print(f"serve stft ({SERVE_K4_REQUESTS} requests of {N_BS} samples at "
          f"{L_ST}/{HOP_ST}, 3 tenants): {SERVE_K4_REQUESTS / wall:.1f} "
          f"req/s | {batches} batches, K4 launches {launches['stft']} (one "
          f"a batch) | {latency} | device busy {busy:.4f} ms a batch, "
          f"{kernels:.0f} kernels and copies a batch (CUPTI), "
          f"{busy * batches / (wall * 1e3):.3f} of the timed pass's "
          f"wall clock | "
          f"rel {worst['stft']:.2e} (tol {ORACLE_TOL:g}) | card {smi}")

    # 3. ragged packing: stft 128/64 and 512/128 at Pareto lengths
    os.environ[srv_mod.RAGGED_ENV] = "1"
    try:
        top = srv_mod.ragged_max()
        ragged = [("stft", {"frame_length": fl, "hop": hop}, rng.randn(
                      n).astype(np.float32), SERVE_TENANTS[i % 3])
                  for fl, hop in ((128, 64), (L_ST, HOP_ST))
                  for i, n in enumerate(pareto_lengths(rng, SERVE_RAGGED,
                                                       fl, top))]
        obs.reset()
        ck.reset_launches()
        with new_server(max_wait_ms=20.0) as srv:
            tickets, answers, wall = served(srv, ragged)
            counts = srv.stats()["counts"]
        launches = dict(ck.LAUNCHES)
    finally:
        del os.environ[srv_mod.RAGGED_ENV]
    worst, _ = check_served("serve ragged", ragged, tickets, answers,
                            obs)
    check(not any(t.degraded for t in tickets), "serve ragged: degraded")
    healthy("serve ragged", obs, faults, breaker)
    print(f"serve ragged ({len(ragged)} stft requests, 128/64 and "
          f"{L_ST}/{HOP_ST}, Pareto lengths up to {top}): "
          f"{counts['batches']} batches, sample goodput "
          f"{counts['useful_samples'] / counts['dispatched_samples']:.3f}"
          f" | rel {worst['stft']:.2e} | none degraded | K4 launches "
          f"{launches['stft']} (a packed row of at most {top} samples "
          f"holds fewer than {ck.STFT_MIN_FRAMES} frames at "
          f"{L_ST}/{HOP_ST})")

    # 4. a served pipeline: matched_stft on ROWS_BS streams of N_BS-sample
    # blocks, captured under the server while plain sosfilt traffic
    # runs on the second worker
    template = rng.randn(K_HEAD).astype(np.float32)

    def matched_stft():
        return pl.Pipeline([pl.matched_filter(template),
                            pl.stft(L_ST, HOP_ST), pl.power()],
                           name="served_mstft").compile(N_BS)

    cp, ref = matched_stft(), matched_stft()
    x_pl = rng.randn(ROWS_BS, SERVE_PL_BLOCKS * N_BS).astype(np.float32)
    sos = iir.butterworth(4, 0.25, "lowpass")
    plain = [("sosfilt", {"sos": sos}, rng.randn(1024).astype(np.float32),
              "plain") for _ in range(8 * SERVE_PL_BLOCKS)]
    obs.reset()
    ck.reset_launches()
    stop = False
    plain_done = []

    def plain_traffic(srv):
        while not stop:
            tk, ys, _ = served(srv, plain[:8])
            plain_done.append((tk, ys))

    with new_server(max_wait_ms=20.0) as srv:
        op = srv.register_pipeline("served_mstft", cp)
        feeder = threading.Thread(target=plain_traffic, args=(srv,))
        feeder.start()
        try:
            states = [None] * ROWS_BS
            outs = [[] for _ in range(ROWS_BS)]
            block_s = []
            for b in range(SERVE_PL_BLOCKS):
                blk = x_pl[:, b * N_BS:(b + 1) * N_BS]
                t0 = time.perf_counter()
                tks = [srv.submit(op=op, x=blk[i],
                                  params={"state": states[i]},
                                  tenant=f"stream{i % 3}")
                       for i in range(ROWS_BS)]
                for i, t in enumerate(tks):
                    outs[i].append(t.result(timeout=120.0)[0])
                    states[i] = t.result()[1]
                    check(t.status == "ok", f"serve pipeline: block {b} "
                          f"stream {i} {t.status}")
                block_s.append(time.perf_counter() - t0)
        finally:
            stop = True
            feeder.join(timeout=120.0)
        check(not feeder.is_alive(), "serve pipeline: plain traffic hung")
        stats = srv.stats()
    captures = [e for e in obs.events() if e["op"] == "pipeline_graph"
                and e.get("pipeline") == "served_mstft"]
    shapes = [tuple(e["shape"]) for e in captures]
    check(len(shapes) == len(set(shapes)) == cp.compile_cache_size()
          and all(s[1] == N_BS for s in shapes),
          f"serve pipeline: captures {shapes}, graphs "
          f"{cp.compile_cache_size()}: want one a row class")
    check(plain_done and all(t.status == "ok" for tk, _ in plain_done
                             for t in tk), "serve pipeline: plain traffic "
          f"{len(plain_done)} rounds, statuses not all ok")
    for tk, ys in plain_done[:4]:
        for (_, params, x, _), y in zip(plain, ys):
            err = rel_err(y, iir.sosfilt_na(sos, x))
            check(err <= IIR_TOL, f"serve pipeline: plain sosfilt rel "
                  f"{err:.3e}")
    # process() on the same blocks, row groups of max_batch streams
    rows = SERVE_MAX_BATCH
    d_max = 0.0
    for g in range(0, ROWS_BS, rows):
        st = None
        for b in range(SERVE_PL_BLOCKS):
            want, st = ref.process(x_pl[g:g + rows, b * N_BS:(b + 1) * N_BS],
                                   st)
            want = want.cpu().numpy()
            got = np.stack([outs[i][b] for i in range(g, g + rows)])
            d_max = max(d_max, float(np.max(np.abs(got - want))
                                     / np.max(np.abs(want))))
    check(d_max <= FUSED_TOL, f"serve pipeline: served vs process "
          f"{d_max:.3e} > {FUSED_TOL}")
    healthy("serve pipeline", obs, faults, breaker)
    print(f"serve pipeline matched_stft ({ROWS_BS} streams x "
          f"{SERVE_PL_BLOCKS} blocks of {N_BS}, workers 2, "
          f"{len(plain_done)} rounds of 8 plain sosfilt requests beside "
          f"it): graphs {shapes} captured in "
          + ", ".join(f"{e['seconds']:.3f}" for e in captures)
          + f" s under the server | served vs process {d_max:.2e} (tol "
          f"{FUSED_TOL:g}) | {ROWS_BS / np.median(block_s):.1f} "
          f"invocations/s (median block round "
          f"{np.median(block_s) * 1e3:.2f} ms) | batches "
          f"{stats['counts']['batches']} | card {smi}")

    # 5. faults and deadlines (the resilience triad), no backoff
    os.environ[faults.FAULT_BACKOFF_ENV] = "0"
    try:
        x256 = rng.randn(256).astype(np.float32)
        sos_req = serve.Request("sosfilt", x256, {"sos": sos})
        with new_server(max_batch=1, max_wait_ms=1.0) as srv:
            ok = srv.submit(sos_req, deadline_ms=60000.0)
            ok.result(timeout=60.0)
        with new_server(max_wait_ms=500.0) as srv:
            late = srv.submit(sos_req, deadline_ms=0.01)
            try:
                late.result(timeout=60.0)
                raised = False
            except serve.DeadlineExceeded:
                raised = True
            batches = srv.stats()["counts"]["batches"]
        check(ok.status == "ok" and raised and late.status == "expired"
              and batches == 0, f"serve deadlines: generous "
              f"{ok.status}, tiny raised {raised} {late.status}, "
              f"{batches} batches")
        lf = {"b": [0.2, 0.3, 0.1], "a": [1.0, -0.4, 0.1]}
        with new_server(max_batch=1, max_wait_ms=1.0, workers=1,
                        probe_every=1) as srv:
            faults.set_fault_plan(
                "serve.dispatch@sosfilt:device_lost:9999")
            try:
                poisoned = [srv.submit(sos_req) for _ in range(6)]
                for t in poisoned:
                    t.result(timeout=60.0)
                sibling = srv.submit(serve.Request("lfilter", x256, lf))
                sibling.result(timeout=60.0)
                opened = [b["state"] for b in srv.stats()["breakers"]]
            finally:
                faults.set_fault_plan(None)
            after = []
            for _ in range(12):
                t = srv.submit(sos_req)
                t.result(timeout=60.0)
                after.append(t.status)
            closed = [b["state"] for b in srv.stats()["breakers"]]
        check({t.status for t in poisoned} == {"degraded"}
              and sibling.status == "ok" and "open" in opened
              and after[-1] == "ok" and set(closed) == {"closed"},
              f"serve breaker: poisoned {[t.status for t in poisoned]}, "
              f"sibling {sibling.status}, breakers {opened} -> {closed}")
        faults.reset_fault_history()
        breaker.reset()
        faults.set_fault_plan("serve.dispatch:device_lost:3")
        try:
            with new_server(max_batch=1, max_wait_ms=1.0, workers=1,
                            probe_every=2) as srv:
                xs = [rng.randn(256).astype(np.float32) for _ in range(3)]
                tks = [srv.submit(serve.Request("sosfilt", x,
                                                {"sos": sos}))
                       for x in xs]
                ys = [t.result(timeout=60.0) for t in tks]
                health = srv.stats()["health"]
        finally:
            faults.set_fault_plan(None)
        same = [np.array_equal(y, srv_mod._oracle_call(
            "sosfilt", x[None, :], {"sos": sos})[0])
            for x, y in zip(xs[:2], ys[:2])]
        check([t.status for t in tks] == ["degraded", "degraded", "ok"]
              and all(same) and health["state"] == "healthy"
              and health["trips"] == 1 and health["recoveries"] == 1,
              f"serve health: {[t.status for t in tks]}, oracle-equal "
              f"{same}, {health}")
        check(rel_err(ys[2], iir.sosfilt_na(sos, xs[2])) <= IIR_TOL,
              "serve health: the recovered answer")
    finally:
        del os.environ[faults.FAULT_BACKOFF_ENV]
        faults.set_fault_plan(None)
        faults.reset_fault_history()
        breaker.reset()
    print("serve faults: a 60 s deadline answered ok, a 0.01 ms one "
          "raised DeadlineExceeded (expired, 0 batches) | "
          "serve.dispatch@sosfilt:device_lost:9999 opened the sosfilt "
          "breaker, lfilter stayed ok, closed again "
          f"{len(after)} requests after the plan cleared | "
          "serve.dispatch:device_lost:3 tripped DEGRADED, 2 answers "
          "equal to the oracle and flagged degraded, the probe "
          "recovered HEALTHY")
    obs.reset()

    # 6. the scrape endpoint
    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=10.0) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    with new_server(obs_port=0) as srv:
        served(srv, schedule[:16])
        port = srv.obs_port
        base = f"http://{obs_http.BIND_HOST}:{port}"
        codes = {path: get(base + path) for path in
                 ("/metrics", "/healthz", "/debug/requests", "/signals")}
        clash = new_server(obs_port=port)
        try:
            clash.start()
            refused = False
        except obs_http.EndpointUnavailable:
            refused = True
        clash.stop()
    debug = json.loads(codes["/debug/requests"][1])
    check(codes["/metrics"][0] == 200
          and "veles_simd_serve_request_latency_bucket" in
          codes["/metrics"][1]
          and codes["/healthz"][0] == 200
          and debug["summary"]["finished"] >= 16 and debug["recent"]
          and codes["/signals"][0] == 200
          and json.loads(codes["/signals"][1])["schema"]
          == "veles-simd-signals-v4" and refused,
          f"serve endpoint: codes "
          f"{ {k: v[0] for k, v in codes.items()} }, refused {refused}")
    healthy("serve endpoint", obs, faults, breaker)
    print(f"serve endpoint: /metrics 200 (serve_request_latency), "
          f"/healthz 200, /debug/requests 200 ({len(debug['recent'])} "
          f"traces), /signals 200 (an empty fleet on a lone server), a "
          f"second server on port {port} "
          f"raised EndpointUnavailable")
    print(f"serve: phase {time.perf_counter() - t_phase:.1f} s")


def fleet_spec(rng):
    """``matched_stft`` as a ``pipeline_from_spec`` dict (the form that
    crosses a process boundary): a 2047-tap matched filter, stft
    512/128, power, on 16,384-sample blocks."""
    template = rng.randn(K_HEAD).astype(np.float32)
    return {"name": "matched_stft", "block": N_BS, "stages": [
        {"stage": "matched_filter", "template": template.tolist()},
        {"stage": "stft", "frame_length": L_ST, "hop": HOP_ST},
        {"stage": "power"}]}


def fleet_traffic(rng, count_mix, count_k4):
    """One wave's plain requests: ``count_mix`` of bench config 11's
    mix and ``count_k4`` of the K4 class (stft 512/128 on 16,384
    samples), interleaved: ``[(kind, op, params, x, tenant), ...]``."""
    items = [("mix",) + r for r in serve_schedule(rng, count_mix)]
    items += [("k4", "stft", {"frame_length": L_ST, "hop": HOP_ST},
               rng.randn(N_BS).astype(np.float32),
               SERVE_TENANTS[i % len(SERVE_TENANTS)])
              for i in range(count_k4)]
    order = rng.permutation(len(items))
    return [items[i] for i in order]


def fleet_wave(router, items, blocks, states, mid=None):
    """Submit a wave flat out through the router (or one server): the
    plain ``items`` and one pipeline block a stream (``blocks[i]`` with
    carried ``states[i]``), ``mid()`` called after half of them;
    returns the plain tickets, the pipeline tickets, the wall seconds
    and the seconds the submits took."""
    from veles.simd_tpu_torch import serve

    subs = [("plain", i) for i in range(len(items))]
    subs += [("pipe", i) for i in range(len(blocks))]
    order = np.random.RandomState(len(items)).permutation(len(subs))
    plain, pipe = [None] * len(items), [None] * len(blocks)
    t0 = time.perf_counter()
    for n, j in enumerate(order):
        kind, i = subs[j]
        if kind == "plain":
            _, op, params, x, tenant = items[i]
            plain[i] = router.submit(serve.Request(
                op, x, params, tenant=tenant),
                deadline_ms=FLEET_DEADLINE_MS)
        else:
            pipe[i] = router.submit(
                op="pipeline:matched_stft", x=blocks[i],
                params={"state": states[i]}, tenant=f"stream{i % 3}",
                deadline_ms=FLEET_DEADLINE_MS)
        if mid is not None and n == len(order) // 2:
            mid()
    t_submit = time.perf_counter() - t0
    for t in plain + pipe:
        t.result(timeout=120.0)
    return plain, pipe, time.perf_counter() - t0, t_submit


def fleet_k4_batches(items, tickets):
    """The K4-class batches that answered ``tickets``: distinct
    (replica, batch id) pairs on the answering attempts' traces."""
    seen = set()
    for (kind, *_), t in zip(items, tickets):
        if kind != "k4":
            continue
        bids = [e["batch"] for e in t.trace.events()
                if e["event"] == "batch_formed"]
        check(len(bids) == 1, f"fleet: a K4 ticket's trace holds "
              f"{len(bids)} batch edges")
        seen.add((t.replica, bids[0]))
    return len(seen)


def fleet_check(what, items, tickets, obs):
    """Every plain ticket ``ok`` within its float64 tolerance, its
    trace closed with one terminal edge; returns (worst error an op,
    failed-over tickets)."""
    from veles.simd_tpu_torch.obs import requests as obs_requests

    terminal = set(obs_requests.TERMINAL_STATUSES.values())
    worst, moved = {}, []
    for (kind, op, params, x, _), t in zip(items, tickets):
        y = t.result()
        check(t.status == "ok" and isinstance(y, np.ndarray),
              f"{what}: {op} ticket {t.status}")
        err = crel_err(y, serve_oracle(op, params, x))
        check(err <= SERVE_TOL[op], f"{what}: {op} n={x.size} rel err "
              f"{err:.3e} > {SERVE_TOL[op]}")
        worst[kind + " " + op] = max(worst.get(kind + " " + op, 0.0), err)
        ends = [e for e in t.trace.events() if e["event"] in terminal]
        check(t.trace.status == "ok" and len(ends) == 1,
              f"{what}: trace {t.trace.rid} {t.trace.status}, "
              f"{len(ends)} terminal edges")
        if getattr(t, "failovers", 0):
            moved.append(t)
    for t in moved:
        dl = t.deadlines_ms
        check(len(dl) >= 2 and all(b <= a for a, b in zip(dl, dl[1:]))
              and dl[-1] > 0 and t.prior_traces
              and all(tr.status == "closed" for tr in t.prior_traces),
              f"{what}: failover deadlines {dl}, prior traces "
              f"{[tr.status for tr in t.prior_traces]}")
    return worst, moved


def fleet_campaign(torch, rng, obs, ck, bm, spec, ref_blocks, spawn):
    """The replica campaign in one spawn mode: a warm wave, the timed
    K4-class wave on 3 replicas (req/s, p50), a wave with r0 killed
    (SIGKILL of the child in subprocess mode) halfway, a wave with r1
    drained halfway, r0 restarted, a last wave; ``/healthz`` polled
    throughout.  Returns the report the fleet lines print."""
    import threading
    import urllib.error
    import urllib.request

    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.obs import http as obs_http

    free0 = torch.cuda.mem_get_info()[0]
    t_start = time.perf_counter()
    group = serve.ReplicaGroup(
        FLEET_REPLICAS, spawn=spawn, max_batch=FLEET_MAX_BATCH,
        max_wait_ms=FLEET_MAX_WAIT_MS, workers=2,
        heartbeat_ms=FLEET_HEARTBEAT_MS, obs_port=0,
        fleet_tick_ms=FLEET_TICK_MS, pipeline_specs=[spec])
    rep = {"spawn": spawn}
    codes, stop_poll = [], threading.Event()

    def poll(port):
        url = f"http://{obs_http.BIND_HOST}:{port}/healthz"
        while not stop_poll.wait(0.02):
            try:
                with urllib.request.urlopen(url, timeout=5.0) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)

    kill_vis = {}

    def watch_r0():
        deadline = time.monotonic() + 60 * group.fleet_tick_s + 5.0
        while time.monotonic() < deadline:
            if obs.signals().health.get("r0") not in (None, "healthy"):
                kill_vis["t_visible"] = time.monotonic()
                return
            time.sleep(group.fleet_tick_s / 5.0)

    def kill_r0():
        kill_vis["t_kill"] = time.monotonic()
        group.kill("r0")
        w = threading.Thread(target=watch_r0)
        w.start()
        kill_vis["watcher"] = w

    obs.reset()
    with group:
        rep["start_s"] = time.perf_counter() - t_start
        rep["ready_s"] = {r.rid: r.ready_s for r in group.replicas}
        rep["children_mem_gb"] = (free0 - torch.cuda.mem_get_info()[0]) \
            / 1e9
        router = serve.FrontRouter(group)
        poller = threading.Thread(target=poll, args=(group.obs_port,))
        poller.start()
        try:
            states = [None] * FLEET_STREAMS
            # warm: the handles and plans of every class on every
            # replica (no pipeline: its graphs are captured under the
            # traffic waves, beside the other replicas' batches)
            warm = fleet_traffic(rng, 24, 12)
            fleet_wave(router, warm, [], [])
            # the timed K4 wave on 3 replicas, run twice: the first
            # pays the first full batches and opens the RPC clients'
            # pooled connections
            timed = fleet_traffic(rng, 0, FLEET_TIMED_K4)
            fleet_wave(router, timed, [], [])
            ck.reset_launches()
            tk, _, wall, t_submit = fleet_wave(router, timed, [], [])
            rep["k4_rps"] = FLEET_TIMED_K4 / wall
            rep["submit_ms"] = t_submit * 1e3
            rep["k4_p50_ms"] = float(np.median(
                [t.trace.total_s for t in tk])) * 1e3
            fleet_check(f"fleet {spawn} timed", timed, tk, obs)
            if spawn == "thread":
                rep["timed_launches"] = ck.LAUNCHES["stft"]
                rep["timed_batches"] = fleet_k4_batches(timed, tk)
                busy, _ = bm.device_profile(lambda: fleet_wave(
                    router, timed, [], []), calls=1)
                rep["busy_ms"], rep["wall_ms"] = busy, wall * 1e3
            ck.reset_launches()
            obs.reset()
            k4_batches, moved, worst, pipes = 0, [], {}, []
            plans = [("kill", kill_r0), ("drain",
                                          lambda: group.drain("r1")),
                     ("restart", None)]
            for b, (step, mid) in enumerate(plans):
                if step == "restart":
                    t0 = time.perf_counter()
                    group.restart("r0")
                    rep["restart_s"] = time.perf_counter() - t0
                    rep["ready_s"]["r0 restarted"] = \
                        group.replica("r0").ready_s
                items = fleet_traffic(rng, FLEET_MIX, FLEET_K4)
                blocks = [ref_blocks[b][i] for i in range(FLEET_STREAMS)]
                tk, pk, _, _ = fleet_wave(router, items, blocks, states,
                                          mid)
                w, m = fleet_check(f"fleet {spawn} {step}", items, tk,
                                   obs)
                for k, v in w.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                moved += m
                if spawn == "thread":
                    k4_batches += fleet_k4_batches(items, tk)
                outs = []
                for i, t in enumerate(pk):
                    out, states[i] = t.result()
                    check(t.status == "ok", f"fleet {spawn} {step}: "
                          f"pipeline stream {i} {t.status}")
                    outs.append(out)
                    if t.failovers:
                        moved.append(t)
                pipes.append(np.stack(outs))
                if step == "kill":
                    kill_vis["watcher"].join(timeout=60.0)
            rep["launches"] = ck.LAUNCHES["stft"]
            rep["k4_batches"] = k4_batches
            rep["stats"] = router.stats()
            rep["captures"] = [e for e in obs.events()
                               if e["op"] == "pipeline_graph"]
            if spawn == "subprocess":
                rep["metrics"] = {}
                for r in group.replicas:
                    if r.state != "up":
                        continue
                    with urllib.request.urlopen(
                            f"http://{obs_http.BIND_HOST}:{r.port}"
                            "/metrics", timeout=10.0) as resp:
                        rep["metrics"][r.rid] = resp.read().decode()
        finally:
            stop_poll.set()
            poller.join(timeout=30.0)
    check(not poller.is_alive(), f"fleet {spawn}: the /healthz poller "
          "hung")
    rep["healthz"] = codes
    rep["moved"], rep["worst"], rep["pipes"] = moved, worst, pipes
    t_vis = kill_vis.get("t_visible")
    rep["visible_ticks"] = (None if t_vis is None else
                            (t_vis - kill_vis["t_kill"])
                            / (FLEET_TICK_MS / 1e3))
    stitched = [obs.stitch_fleet_trace(t) for t in moved
                if t.prior_traces][:1]
    rep["stitched"] = stitched[0]["otherData"] if stitched else None
    return rep


def fleet_single(rng, obs):
    """The timed K4-class wave through one ``serve.Server``: at the
    campaign's knobs (``max_batch`` 32, 150 ms, workers 2) and at the
    serve phase's (``max_batch`` 8, 2 ms); returns both req/s."""
    from veles.simd_tpu_torch import serve

    out = {}
    for label, mb, mw in (("campaign", FLEET_MAX_BATCH,
                           FLEET_MAX_WAIT_MS),
                          ("serve", SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS)):
        timed = fleet_traffic(rng, 0, FLEET_TIMED_K4)
        with serve.Server(max_batch=mb, max_wait_ms=mw,
                          workers=2) as srv:
            fleet_wave(srv, timed[:32], [], [])      # warm
            tickets, _, wall, t_submit = fleet_wave(srv, timed, [], [])
        fleet_check(f"fleet single {label}", timed, tickets, obs)
        out[label] = (FLEET_TIMED_K4 / wall, t_submit * 1e3)
    return out


def fleet_scaler(rng, obs):
    """A ramp over a 1-replica thread group with the scaler armed at
    tools/chaos.py:1260-1266's control settings: bursts of the mix
    until a ``scale_up`` is decided, then idle until a
    ``scale_down``; nothing lost.  Returns the report."""
    from veles.simd_tpu_torch import serve

    group = serve.ReplicaGroup(
        1, max_batch=8, max_wait_ms=4.0, workers=2,
        heartbeat_ms=FLEET_HEARTBEAT_MS, obs_port=0,
        fleet_tick_ms=FLEET_TICK_MS, scaler=True, scaler_tick_ms=30.0,
        scaler_kwargs=dict(min_replicas=1, max_replicas=3,
                           cooldown_s=0.35, up_ticks=2, down_ticks=12,
                           depth_high=6.0, idle_depth=1.0))
    tickets, alive = [], []

    def actions():
        return obs.scaler_snapshot()["actions"]

    t0 = time.perf_counter()
    with group:
        router = serve.FrontRouter(group)
        alive.append(group.alive())
        for _ in range(40):                          # the peak
            burst = serve_schedule(rng, 150)
            tks = [router.submit(serve.Request(op, x, params,
                                               tenant=tenant),
                                 deadline_ms=FLEET_DEADLINE_MS)
                   for op, params, x, tenant in burst]
            for t in tks:
                t.result(timeout=120.0)
            tickets += list(zip(burst, tks))
            alive.append(group.alive())
            if actions().get("scale_up"):
                break
        t_up = time.perf_counter() - t0
        deadline = time.monotonic() + 15.0           # the idle tail
        while not actions().get("scale_down") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        snap = obs.scaler_snapshot()
        alive.append(group.alive())
    lost = sum(1 for _, t in tickets if not t.done())
    bad = [t.status for _, t in tickets if t.status != "ok"]
    for (op, params, x, _), t in tickets[:64]:
        err = crel_err(t.result(), serve_oracle(op, params, x))
        check(err <= SERVE_TOL[op], f"fleet scaler: {op} rel {err:.3e}")
    check(snap["actions"].get("scale_up", 0) >= 1
          and snap["actions"].get("scale_down", 0) >= 1 and lost == 0
          and not bad, f"fleet scaler: actions {snap['actions']}, "
          f"noops {snap['noops']}, lost {lost}, not ok {bad[:4]}")
    return {"requests": len(tickets), "t_up": t_up,
            "actions": snap["actions"], "noops": snap["noops"],
            "alive": alive, "ticks": snap["ticks"],
            "seconds": time.perf_counter() - t0}


def fleet_phase(torch, rng, bm, obs, faults, breaker, ck, smi):
    """The serving fleet on the card (``serve.ReplicaGroup`` behind
    ``serve.FrontRouter``): the JAX replica campaign in thread mode
    and over the RPC data plane in subprocess mode, K4 a K4-class
    batch in every replica, then the scaler's ramp."""
    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch.serve import rpc

    t_phase = time.perf_counter()
    spec = fleet_spec(rng)
    x_pl = rng.randn(3, FLEET_STREAMS, N_BS).astype(np.float32)
    ref = pl.pipeline_from_spec(spec)
    # the float64 oracle of each stream over the three blocks, and the
    # fused chain on the same blocks (8 streams a batch)
    oracle = ref.oracle(np.concatenate(list(x_pl), axis=-1))
    want, st = [], None
    for b in range(3):
        y, st = ref.process(x_pl[b], st)
        want.append(y.cpu().numpy())
    single = fleet_single(rng, obs)
    reps = {}
    for spawn in ("thread", "subprocess"):
        # the router's RPC clients: one pooled connection a request a
        # child can batch; with fewer, a child's batch never fills and
        # waits out max_wait
        os.environ[rpc.RPC_CONNS_ENV] = str(FLEET_MAX_BATCH)
        try:
            reps[spawn] = rep = fleet_campaign(torch, rng, obs, ck, bm,
                                               spec, x_pl, spawn)
        finally:
            del os.environ[rpc.RPC_CONNS_ENV]
        # served on batches of 1 to 8 streams (cuFFT plans of their
        # own): held to the float64 oracle, as the pipeline phase holds
        # matched_stft, and compared with process() on 8 streams
        rep["pipe_err"] = rel_err(np.concatenate(rep["pipes"], axis=1),
                                  oracle)
        check(rep["pipe_err"] <= ORACLE_TOL, f"fleet {spawn}: served "
              f"pipeline vs its oracle {rep['pipe_err']:.3e} > "
              f"{ORACLE_TOL}")
        rep["pipe_fused"] = max(
            float(np.max(np.abs(got - w)) / np.max(np.abs(w)))
            for got, w in zip(rep["pipes"], want))
        st = rep["stats"]
        check(st["failovers"] >= 1 and rep["moved"],
              f"fleet {spawn}: no failover ({st['failovers']})")
        check(rep["healthz"] and set(rep["healthz"]) == {200},
              f"fleet {spawn}: /healthz answered "
              f"{sorted(set(rep['healthz']))}")
        check(rep["visible_ticks"] is not None
              and rep["visible_ticks"] <= FLEET_VISIBLE_TICKS,
              f"fleet {spawn}: r0 read non-healthy after "
              f"{rep['visible_ticks']} ticks")
        sm = rep["stitched"]
        check(sm is not None and sm["attempts"] >= 2
              and len(set(sm["replicas"])) >= 2,
              f"fleet {spawn}: stitched fleet trace {sm}")
        check(obs.counter_value("router_dedup") == 0
              and obs.counter_value("serve_double_answer") == 0,
              f"fleet {spawn}: a request was answered twice")
        if spawn == "thread":
            check(rep["launches"] == rep["k4_batches"] > 0
                  and rep["timed_launches"] == rep["timed_batches"],
                  f"fleet thread: K4 launches {rep['launches']} for "
                  f"{rep['k4_batches']} K4-class batches (timed "
                  f"{rep['timed_launches']} / {rep['timed_batches']})")
            check(rep["captures"] and all(
                e["decision"] == "captured" for e in rep["captures"]),
                f"fleet thread: pipeline captures {rep['captures']}")
        else:
            check(rep["launches"] == 0, "fleet subprocess: the parent "
                  f"launched K4 {rep['launches']} times")
            rows = {rid: [ln for ln in text.splitlines()
                          if ln.startswith("veles_simd_resource_")
                          and FLEET_RESOURCE in ln]
                    for rid, text in rep["metrics"].items()}
            pipes = {rid: any('route="matched_stft"' in ln
                              for ln in text.splitlines())
                     for rid, text in rep["metrics"].items()}
            check(len(rows) >= 2 and all(rows.values())
                  and all(pipes.values()),
                  f"fleet subprocess: children without the K4 resource "
                  f"row or the pipeline row: "
                  f"{ {k: len(v) for k, v in rows.items()} } {pipes}")
            rep["rows"] = rows
        healthy(f"fleet {spawn}", obs, faults, breaker)
    scal = fleet_scaler(rng, obs)
    healthy("fleet scaler", obs, faults, breaker)
    th, sub = reps["thread"], reps["subprocess"]
    for spawn, rep in reps.items():
        st = rep["stats"]
        print(f"fleet {spawn} ({FLEET_REPLICAS} replicas, max_batch "
              f"{FLEET_MAX_BATCH}, max_wait {FLEET_MAX_WAIT_MS} ms, "
              f"workers 2, heartbeat {FLEET_HEARTBEAT_MS} ms, tick "
              f"{FLEET_TICK_MS} ms; waves of {FLEET_MIX} mix + "
              f"{FLEET_K4} K4-class + {FLEET_STREAMS} matched_stft "
              f"blocks): r0 killed, r1 drained, r0 restarted | "
              f"failovers {st['failovers']}, answered "
              f"{json.dumps(st['answered_by_replica'])}, none lost or "
              f"twice | r0 non-healthy in obs.signals() after "
              f"{rep['visible_ticks']:.1f} ticks | stitched "
              f"{rep['stitched']['attempts']} attempts on "
              f"{rep['stitched']['replicas']}, deadlines_ms "
              f"{[round(d, 1) for d in rep['stitched']['deadlines_ms']]}"
              f" | /healthz 200 x {len(rep['healthz'])} | worst rel "
              + json.dumps({k: float(f"{v:.2e}") for k, v in
                            sorted(rep["worst"].items())})
              + f" | pipeline vs oracle {rep['pipe_err']:.2e} (tol "
              f"{ORACLE_TOL:g}), vs process() on 8 streams "
              f"{rep['pipe_fused']:.2e}")
    print(f"fleet thread K4: launches {th['launches']} = K4-class "
          f"batches {th['k4_batches']} summed over the replicas (timed "
          f"wave {th['timed_launches']} = {th['timed_batches']}) | "
          f"pipeline graphs captured beside the other replicas' "
          f"batches: {[tuple(e['shape']) for e in th['captures']]} in "
          + ", ".join(f"{e['seconds']:.3f}" for e in th["captures"])
          + " s, no capture error")
    print(f"fleet subprocess K4: the parent launched none; each live "
          f"child's /metrics carries the resource rows "
          f"{ {k: len(v) for k, v in sub['rows'].items()} } "
          f"({FLEET_RESOURCE}) and the matched_stft pipeline row | "
          f"spawn to ready s "
          + json.dumps({k: round(v, 3) for k, v in
                        sub["ready_s"].items()})
          + f" | RPC conns {FLEET_MAX_BATCH} a child (= max_batch) | "
          f"group start {sub['start_s']:.2f} s, restart "
          f"{sub['restart_s']:.2f} s | card memory taken by the "
          f"children {sub['children_mem_gb']:.2f} GB")
    print(f"fleet K4 req/s ({FLEET_TIMED_K4} requests of {N_BS} samples "
          f"at {L_ST}/{HOP_ST}, flat out; the submits' ms in brackets): "
          f"thread fleet {th['k4_rps']:.1f} ({th['submit_ms']:.1f}) | "
          f"subprocess fleet {sub['k4_rps']:.1f} ({sub['submit_ms']:.1f})"
          f" | one server at the campaign's knobs "
          f"{single['campaign'][0]:.1f} ({single['campaign'][1]:.1f}), "
          f"at the serve phase's (max_batch {SERVE_MAX_BATCH}, "
          f"{SERVE_MAX_WAIT_MS} ms) {single['serve'][0]:.1f} "
          f"({single['serve'][1]:.1f}) | p50 thread "
          f"{th['k4_p50_ms']:.2f} ms,"
          f" subprocess {sub['k4_p50_ms']:.2f} ms: the RPC adds "
          f"{sub['k4_p50_ms'] - th['k4_p50_ms']:.2f} ms | device busy "
          f"{th['busy_ms']:.3f} ms of the thread fleet's "
          f"{th['wall_ms']:.1f} ms wave ({th['busy_ms'] / th['wall_ms']:.3f}"
          f" of the wall clock; the children's busy share not measured: "
          f"the parent's profiler sees its own process) | card {smi}")
    print(f"fleet scaler (1 replica, max 3, ticks 30 ms, up 2, down 12, "
          f"cooldown 0.35 s, depth_high 6): {scal['requests']} requests "
          f"in bursts of 150, scale_up after {scal['t_up']:.2f} s | "
          f"actions {json.dumps(scal['actions'])}, no-ops "
          f"{json.dumps(scal['noops'])} in {scal['ticks']} ticks | "
          f"alive {scal['alive'][0]} -> {max(scal['alive'])} -> "
          f"{scal['alive'][-1]} | none lost")
    print(f"fleet: phase {time.perf_counter() - t_phase:.1f} s")


def conv64_card(torch, x, h):
    """float64 full convolution of every row of x with h, on the card
    (``torch.fft`` in float64)."""
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (torch.fft.rfft(x.double(), m) * torch.fft.rfft(h.double(), m))
    return torch.fft.irfft(spec, m)[..., : n + k - 1]


def wavelet64_last(torch, x, hi, lo, stride, dilation):
    """float64 periodic DWT (stride 2) or SWT level (stride 1, dilated)
    along the last axis on the card: ``y[t] = sum_j f[j] x[(stride t +
    j dilation) mod n]``; returns ``(hi, lo)``."""
    F = torch.nn.functional
    n, k = x.shape[-1], hi.shape[-1]
    ext = torch.cat([x, x[..., :k * dilation]], dim=-1).double()
    taps = torch.stack([hi, lo]).double().reshape(2, 1, k)
    out = F.conv1d(ext.reshape(-1, 1, ext.shape[-1]), taps, stride=stride,
                   dilation=dilation)[..., : n // stride]
    out = out.reshape(tuple(x.shape[:-1]) + (2, n // stride))
    return out[..., 0, :], out[..., 1, :]


def dwt2_64(torch, img, hi, lo):
    """float64 separable periodic 2D DWT: ``(ll, lh, hl, hh)``."""
    hi_r, lo_r = wavelet64_last(torch, img, hi, lo, 2, 1)
    bands, lows = (b.transpose(-1, -2) for b in wavelet64_last(
        torch, torch.stack([hi_r, lo_r]).transpose(-1, -2), hi, lo, 2, 1))
    return lows[1], bands[1], lows[0], bands[0]


def abs_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(np.all(np.isfinite(got)), "non-finite output")
    return float(np.max(np.abs(got - want)))


def parallel_phase(torch, rng, bm, obs, faults, breaker, ck, smi):
    """The sharded families on an 8-shard mesh of ``cuda:0`` (the JAX
    tests' and ``tools/bench_multichip.py``'s 8-device mesh), at the
    JAX package's users' sizes: each call against a float64 oracle at
    its JAX test's tolerance, its launches, chained and busy ms beside
    the single-card op; the rest of the public surface once at the JAX
    tests' sizes; no ``mesh_degrade`` on any of it; then one forced
    ``parallel.sharded_matmul:device_lost`` plan that degrades to the
    single-card twin and re-closes the breaker."""
    from scipy import signal as ss

    from veles.simd_tpu_torch import parallel as par
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import filters as fl
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.ops import normalize as nm
    from veles.simd_tpu_torch.ops import resample as rs
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.parallel import fourier as fr

    t_phase = time.perf_counter()
    degrades = [0]

    def reset_obs():
        # mesh_degrade over the phase, across the resets that clear the
        # decision events read below
        degrades[0] += sum(c["value"] for c in obs.snapshot()["counters"]
                           if c["name"] == "mesh_degrade")
        obs.reset()

    reset_obs()
    dev = torch.device("cuda", 0)

    def card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    sp8 = par.make_mesh({"sp": PAR_SHARDS})
    dpsp = par.make_mesh({"dp": 2, "sp": PAR_SHARDS // 2})
    tp8 = par.make_mesh({"tp": PAR_SHARDS})
    check({str(d) for d in sp8.devices.flat} == {str(dev)}
          and sp8.size == PAR_SHARDS,
          f"parallel: the default mesh is {sp8}, want {PAR_SHARDS} "
          f"shards of {dev}")
    P = wv.ExtensionType.PERIODIC
    hi8, lo8 = (card(f) for f in wv._filters("daub", 8))

    def timed(name, mesh_name, call, single, err, tol, expect=()):
        """One sharded call: its error (``err(out)`` against the
        oracle), the launches of one call, chained and busy ms beside
        the single-card op's."""
        t_call = time.perf_counter()
        ck.reset_launches()
        out = call()
        torch.cuda.synchronize()
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        e = err(out)
        check(e <= tol, f"parallel {name}: err {e:.3e} > {tol}")
        for k in expect:
            check(launches.get(k, 0) > 0,
                  f"parallel {name}: no {k} launch ({launches})")
        ch = bm.device_time_ms(call, iters=PAR_ITERS, warmup=1)
        busy = bm.device_busy_ms(call, calls=PAR_CALLS, keep=1)
        s_ch = bm.device_time_ms(single, iters=PAR_ITERS, warmup=1)
        s_busy = bm.device_busy_ms(single, calls=PAR_SINGLE_CALLS)
        print(f"parallel {name} ({mesh_name}): err {e:.2e} <= {tol} | "
              f"launches {json.dumps(launches)} | mesh chained "
              f"{ch:.4f} ms, busy {busy:.4f} ms | single card chained "
              f"{s_ch:.4f} ms, busy {s_busy:.4f} ms | mesh / single: "
              f"chained {ch / s_ch:.2f}, busy {busy / s_busy:.2f} | "
              f"{time.perf_counter() - t_call:.1f} s | card {smi}")
        return out

    # the headline: 1M x 2047, one-hop halo (bench.py:180-217)
    x_h = card(rng.randn(N_HEAD))
    h_h = card(rng.randn(K_HEAD))
    want = conv64_card(torch, x_h, h_h).cpu().numpy()
    handle = cv.convolve_initialize(N_HEAD, K_HEAD)
    timed(f"sharded_convolve {N_HEAD}x{K_HEAD}", "sp8",
          lambda: par.sharded_convolve(x_h, h_h, sp8),
          lambda: cv.convolve(handle, x_h, h_h),
          lambda y: rel_err(y.cpu().numpy(), want), 1e-3)
    # the ring: k - 1 exceeds the 163,840-sample block
    h_r = card(rng.randn(K_RING))
    want = conv64_card(torch, x_h, h_r).cpu().numpy()
    handle_r = cv.convolve_initialize(N_HEAD, K_RING)
    reset_obs()
    timed(f"sharded_convolve_ring {N_HEAD}x{K_RING}", "sp8",
          lambda: par.sharded_convolve(x_h, h_r, sp8),
          lambda: cv.convolve(handle_r, x_h, h_r),
          lambda y: rel_err(y.cpu().numpy(), want), 1e-4)
    ring = [e for e in obs.events() if e["op"] == "sharded_convolve"]
    check(ring and ring[0]["decision"] == "ring",
          f"parallel: the ring was not selected ({ring[:1]})")
    # dp2 x sp4: 64 x 262,144 x 129
    x_b = card(rng.randn(ROWS_PB, N_PB))
    h_b = card(rng.randn(K_FB))
    want = conv64_card(torch, x_b, h_b).cpu().numpy()
    timed(f"sharded_convolve_batch {ROWS_PB}x{N_PB}x{K_FB}", "dp2xsp4",
          lambda: par.sharded_convolve_batch(x_b, h_b, dpsp),
          lambda: cv.convolve_simd(x_b, h_b),
          lambda y: rel_err(y.cpu().numpy(), want), 1e-3)
    # K5's geometry, one sharded image at a time
    x_2 = card(rng.randn(IMGS_2D, N_2D, N_2D))
    h_2 = card(rng.randn(K_2D, K_2D))
    want = conv2d64(x_2.cpu().numpy(), h_2.cpu().numpy())
    timed(f"sharded_convolve2d {IMGS_2D}x{N_2D}^2 {K_2D}x{K_2D}",
          "dp2xsp4",
          lambda: torch.stack([par.sharded_convolve2d(im, h_2, dpsp)
                               for im in x_2]),
          lambda: cv2.convolve2d(x_2, h_2),
          lambda y: abs_err(y.cpu().numpy(), want), 1e-3)
    # the all-to-all 2D DWT, 4096^2 daub8, and its inverse
    img = card(rng.randn(N_PW, N_PW))
    want = [b.cpu().numpy() for b in dwt2_64(torch, img, hi8, lo8)]
    bands = timed(f"sharded_wavelet_apply2d {N_PW}^2 daub8", "sp8",
                  lambda: par.sharded_wavelet_apply2d("daub", 8, P, img,
                                                      sp8),
                  lambda: wv.wavelet_apply2d("daub", 8, P, img),
                  lambda q: max(abs_err(b.cpu().numpy(), w)
                                for b, w in zip(q, want)), 5e-4,
                  expect=("filter_bank",))
    timed(f"sharded_wavelet_reconstruct2d {N_PW}^2 daub8", "sp8",
          lambda: par.sharded_wavelet_reconstruct2d("daub", 8, *bands,
                                                    sp8),
          lambda: wv.wavelet_reconstruct2d("daub", 8, *bands),
          lambda y: abs_err(y.cpu().numpy(), img.cpu().numpy()),
          ROUND_TRIP_TOL)
    # the sharded SWT, 2^20 daub8 3 levels, and its inverse
    x_s = card(rng.randn(N_SWT))
    want, cur = [], x_s
    for lvl in range(LEVELS):
        h_l, cur = wavelet64_last(torch, cur, hi8, lo8, 1, 1 << lvl)
        want.append(h_l.cpu().numpy())
    want.append(cur.cpu().numpy())
    coeffs = timed(f"sharded_swt {N_SWT} daub8 {LEVELS} levels", "sp8",
                   lambda: par.sharded_swt("daub", 8, LEVELS, x_s, sp8),
                   lambda: wv.stationary_wavelet_transform(
                       "daub", 8, P, x_s, LEVELS),
                   lambda c: max(abs_err(b.cpu().numpy(), w)
                                 for b, w in zip(c, want)), 5e-4)
    timed(f"sharded_swt_reconstruct {N_SWT} daub8 {LEVELS} levels",
          "sp8",
          lambda: par.sharded_swt_reconstruct("daub", 8, LEVELS, coeffs,
                                              sp8),
          lambda: wv.stationary_wavelet_inverse_transform(
              "daub", 8, coeffs),
          lambda y: abs_err(y.cpu().numpy(), x_s.cpu().numpy()),
          ROUND_TRIP_TOL)
    # the STFT at its acceptance geometry (bench.py:640-680) and at
    # tools/bench_multichip.py:265-270's
    x_st = card(rng.randn(N_ST))
    want = sp.stft_na(x_st.cpu().numpy(), L_ST, HOP_ST)
    timed(f"sharded_stft {N_ST} at {L_ST}/{HOP_ST}", "sp8",
          lambda: par.sharded_stft(x_st, L_ST, HOP_ST, sp8),
          lambda: sp.stft(x_st, L_ST, HOP_ST),
          lambda y: crel_err(y.cpu().numpy(), want), FOURIER_TOL)
    x_pst = card(rng.randn(ROWS_PST, N_PST))
    want = sp.stft_na(x_pst.cpu().numpy(), L_PST, HOP_PST)
    timed(f"sharded_stft {ROWS_PST}x{N_PST} at {L_PST}/{HOP_PST}", "sp8",
          lambda: par.sharded_stft(x_pst, L_PST, HOP_PST, sp8),
          lambda: sp.stft(x_pst, L_PST, HOP_PST),
          lambda y: crel_err(y.cpu().numpy(), want), FOURIER_TOL)
    # sharded_rfft 2^18 (tools/bench_multichip.py:264): the static pick,
    # then the factorized route forced
    x_f = card(rng.randn(N_PRF))
    want = np.fft.rfft(x_f.cpu().numpy().astype(np.float64))
    reset_obs()
    timed(f"sharded_rfft {N_PRF} (static pick)", "sp8",
          lambda: fr.sharded_rfft(x_f, sp8),
          lambda: fr.sharded_rfft(x_f, sp8, route="local_fft"),
          lambda y: crel_err(y.cpu().numpy(), want), FOURIER_TOL)
    pick = [e for e in obs.events() if e["op"] == "sharded_rfft"][0]
    timed(f"sharded_rfft {N_PRF} (sharded_matmul_dft forced)", "sp8",
          lambda: fr.sharded_rfft(x_f, sp8, route="sharded_matmul_dft"),
          lambda: fr.sharded_rfft(x_f, sp8, route="local_fft"),
          lambda y: crel_err(y.cpu().numpy(), want), FOURIER_TOL)
    # sosfilt 8 x 2^20, butterworth(4, 0.25)
    sos = iir.butterworth(4, 0.25, "lowpass")
    x_i = card(rng.randn(ROWS_PSOS, N_PSOS))
    want = ss.sosfilt(sos, x_i.cpu().numpy().astype(np.float64), axis=-1)
    timed(f"sharded_sosfilt {ROWS_PSOS}x{N_PSOS}", "sp8",
          lambda: par.sharded_sosfilt(sos, x_i, sp8),
          lambda: iir.sosfilt(sos, x_i),
          lambda y: abs_err(y.cpu().numpy(), want),
          5e-5 * max(1.0, float(np.max(np.abs(want)))))
    # the tensor-parallel GEMM, 2048^3
    a = card(rng.randn(N_GEMM2, N_GEMM2))
    b = card(rng.randn(N_GEMM2, N_GEMM2))
    want = (a.double() @ b.double()).cpu().numpy()
    timed(f"sharded_matmul {N_GEMM2}^3", "tp8",
          lambda: par.sharded_matmul(a, b, tp8),
          lambda: mx.matrix_multiply(a, b),
          lambda y: abs_err(y.cpu().numpy(), want), 1e-3)

    # the rest of the public surface once, at the JAX tests' sizes
    # (tests/test_parallel.py), each against its oracle
    rest = {}

    def once(name, fn, err, tol):
        ck.reset_launches()
        e = err(fn())
        check(e <= tol, f"parallel {name}: err {e:.3e} > {tol}")
        rest[name] = [float(f"{e:.3e}"),
                      {k: v for k, v in ck.LAUNCHES.items() if v}]

    def rnd(*shape):
        return rng.randn(*shape).astype(np.float32)

    x1 = rnd(1024)
    k2 = rnd(40, 30)
    i64 = rnd(64, 64)
    once("sharded_convolve2d_ring", lambda: par.sharded_convolve2d_ring(
        i64, k2, dpsp), lambda y: rel_err(y.cpu(), conv2d64(i64, k2)),
        1e-4)
    i48 = rnd(64, 48)
    once("sharded_swt_apply2d", lambda: par.sharded_swt_apply2d(
        "daub", 8, 2, wv.ExtensionType.MIRROR, i48, sp8),
        lambda q: max(abs_err(g.cpu(), w) for g, w in zip(
            q, wv.stationary_wavelet_apply2d(
                "daub", 8, 2, wv.ExtensionType.MIRROR, i48, simd=False))),
        5e-4)
    once("sharded_wavelet_packet_transform2d",
         lambda: par.sharded_wavelet_packet_transform2d(
             "daub", 4, P, i64, 2, dpsp, axis="sp"),
         lambda q: max(abs_err(g.cpu(), w) for g, w in zip(
             q, wv.wavelet_packet_transform2d("daub", 4, P, i64, 2,
                                              simd=False))), 5e-4)
    once("sharded_wavelet_apply", lambda: par.sharded_wavelet_apply(
        "daub", 8, x1[:512], sp8),
        lambda q: max(abs_err(g.cpu(), w) for g, w in zip(
            q, wv.wavelet_apply_na("daub", 8, P, x1[:512]))), 5e-4)
    once("sharded_wavelet_reconstruct", lambda: par.
         sharded_wavelet_reconstruct("sym", 12, *par.sharded_wavelet_apply(
             "sym", 12, x1, sp8), sp8),
         lambda y: abs_err(y.cpu(), x1), ROUND_TRIP_TOL)
    coeffs = par.sharded_wavelet_transform("daub", 8, x1, 3, dpsp,
                                           axis="sp")
    once("sharded_wavelet_transform", lambda: coeffs,
         lambda c: max(abs_err(g.cpu(), w) for g, w in zip(
             c, wv.wavelet_transform("daub", 8, P, x1, 3, simd=False))),
         5e-4)
    once("sharded_wavelet_inverse_transform",
         lambda: par.sharded_wavelet_inverse_transform(
             "daub", 8, coeffs, dpsp, axis="sp"),
         lambda y: abs_err(y.cpu(), x1), 5e-4)
    x2k = rnd(2048)
    spec = sp.stft_na(x2k, 128, 32).astype(np.complex64)
    once("sharded_istft", lambda: par.sharded_istft(spec, 2048, 128, 32,
                                                    sp8),
         lambda y: rel_err(y.cpu(), sp.istft_na(spec, 2048, 128, 32)),
         1e-4)
    x8k = rnd(8192)
    _, pw = sp.welch_na(x8k, fs=100.0, nperseg=256)
    once("sharded_welch", lambda: par.sharded_welch(
        x8k, sp8, fs=100.0, nperseg=256)[1],
        lambda p: rel_err(p.cpu(), pw), 1e-5)
    x23 = rnd(2352)
    once("sharded_resample_poly", lambda: par.sharded_resample_poly(
        x23, 160, 147, sp8), lambda y: abs_err(
        y.cpu(), rs.resample_poly(x23, 160, 147, simd=False)), 1e-5)
    once("sharded_order_filter", lambda: par.sharded_order_filter(
        x1, 0, 7, sp8), lambda y: abs_err(
        y.cpu(), fl.order_filter_na(x1, 0, 7)), 1e-6)
    once("sharded_medfilt", lambda: par.sharded_medfilt(x2k, 9, sp8),
         lambda y: abs_err(y.cpu(), fl.medfilt_na(x2k, 9)), 1e-6)
    sg = fl.savgol_filter(x1, 11, 3, deriv=1, delta=0.5, simd=False)
    once("sharded_savgol_filter", lambda: par.sharded_savgol_filter(
        x1, 11, 3, sp8, deriv=1, delta=0.5),
        lambda y: abs_err(y.cpu(), sg),
        5e-4 * max(1.0, float(np.max(np.abs(sg)))))
    t_ls = np.sort(rng.rand(1021)) * 100.0
    x_ls = (np.sin(1.3 * t_ls) + 0.4 * rng.randn(1021)).astype(np.float32)
    f_ls = np.linspace(0.5, 3.0, 64)
    once("sharded_lombscargle", lambda: par.sharded_lombscargle(
        t_ls, x_ls, f_ls, sp8), lambda p: rel_err(
        p.cpu(), sp.lombscargle_na(t_ls, x_ls, f_ls)), 1e-3)
    u8 = rng.randint(0, 256, (61, 33)).astype(np.uint8)
    once("sharded_normalize2d", lambda: par.sharded_normalize2d(u8, sp8),
         lambda y: abs_err(y.cpu(), nm.normalize2D(u8, simd=False)), 1e-6)
    xb = rnd(16, 256)
    dwt = par.data_parallel(lambda v: wv.wavelet_apply("daub", 8, P, v),
                            par.make_mesh({"dp": PAR_SHARDS}))
    once("data_parallel", lambda: dwt(xb),
         lambda q: max(abs_err(g.cpu(), w) for g, w in zip(
             q, wv.wavelet_apply_na("daub", 8, P, xb))), 1e-5)
    xc = (rng.randn(512) + 1j * rng.randn(512)).astype(np.complex64)
    once("sharded_dft", lambda: fr.sharded_dft(
        xc, sp8, route="sharded_matmul_dft"), lambda y: crel_err(
        y.cpu(), np.fft.fft(xc.astype(np.complex128))), 1e-4)
    x96 = rnd(960)
    once("sharded_irfft", lambda: fr.sharded_irfft(
        np.fft.rfft(x96.astype(np.float64)).astype(np.complex64), 960,
        sp8, route="sharded_matmul_dft"), lambda y: rel_err(y.cpu(), x96),
        1e-4)
    hyb = par.distributed.hybrid_mesh(ici={"sp": PAR_SHARDS})
    check(par.distributed.process_count() == 1
          and par.distributed.process_index() == 0,
          "parallel: a process group on the one card")
    once("hybrid_mesh sp8 + sharded_convolve", lambda: par.
         sharded_convolve(x1, rnd(65), hyb),
         lambda y: 0.0 if tuple(y.shape) == (1088,) else 1.0, 0.0)
    # no operand moves between the CPU and the card behind the caller
    cpu8 = par.make_mesh({"sp": PAR_SHARDS}, devices=["cpu"] * PAR_SHARDS)
    for mesh, x in ((cpu8, x_h[:1024]), (sp8, x_h[:1024].cpu())):
        try:
            par.sharded_convolve(x, h_b, mesh)
        except ValueError:
            continue
        check(False, f"parallel: a {x.device} operand ran on {mesh}")
    print("parallel rest (JAX tests' sizes; err, launches): "
          + json.dumps(rest))
    reset_obs()
    states = {f"{b['key']}": b["state"] for b in breaker.snapshot()
              if b["site"] == "parallel.dispatch"}
    check(degrades[0] == 0 and all(s == breaker.CLOSED
                                   for s in states.values()),
          f"parallel: healthy calls degraded ({degrades[0]}) or opened a "
          f"breaker ({states})")
    healthy("parallel", obs, faults, breaker)
    print(f"parallel healthy: mesh_degrade {degrades[0]} | "
          f"{len(states)} parallel.dispatch breakers, all closed | "
          f"sharded_rfft {N_PRF} static pick {pick['decision']}")

    # the degrade path: the JAX package's verify flow, on a fresh
    # breaker that probes every second call
    breaker.reset()
    os.environ[faults.FAULT_BACKOFF_ENV] = "0"
    os.environ[breaker.BREAKER_PROBE_EVERY_ENV] = "2"
    want = (a.double() @ b.double()).cpu().numpy()
    errs = []
    try:
        with faults.fault_plan("parallel.sharded_matmul:device_lost:9999"):
            for _ in range(5):
                errs.append(abs_err(par.sharded_matmul(a, b, tp8).cpu(),
                                    want))
            br = breaker.lookup("parallel.dispatch",
                                ("sharded_matmul", "tp8@tp"))
            opened = br.state
            degraded = obs.counter_value("mesh_degrade",
                                         op="sharded_matmul")
        for _ in range(4):
            errs.append(abs_err(par.sharded_matmul(a, b, tp8).cpu(), want))
        closed = br.state
    finally:
        del os.environ[faults.FAULT_BACKOFF_ENV]
        del os.environ[breaker.BREAKER_PROBE_EVERY_ENV]
    check(opened != breaker.CLOSED and degraded >= 2
          and closed == breaker.CLOSED and max(errs) <= 1e-3,
          f"parallel: the forced plan did not degrade and re-close "
          f"(breaker {opened} -> {closed}, mesh_degrade {degraded}, "
          f"err {max(errs):.3e})")
    print(f"parallel degrade: parallel.sharded_matmul:device_lost -> "
          f"mesh_degrade {degraded}, breaker {opened}, a @ b err "
          f"{max(errs):.2e} <= 1e-3 | plan cleared: breaker {closed}")
    faults.reset_fault_history()
    breaker.reset()
    obs.reset()
    print(f"parallel: phase {time.perf_counter() - t_phase:.1f} s | card "
          f"{smi}")


# the cabi phase: the C entries the kernels serve, at the main path's
# shapes, through the port's C bridge loaded in this process
CABI_SUITE_TIMEOUT_S = 600
CABI_REPEATS = 5


def cabi_phase(rng, bm, ck, smi, kind):
    """The port's C ABI on the card: csrc's C suite and example built
    unchanged against the port's libveles_simd.so and run with no
    VELES_SIMD_PLATFORM, then the C entries that reach K1, K4, K5 and K2
    called through C from this process (ctypes; the bridge's PyGILState
    path runs the shim in this interpreter), each against float64 and
    beside the same call made from Python."""
    import ctypes
    import subprocess

    from veles.simd_tpu_torch import cabi
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.ops import wavelet as wv

    t_phase = time.perf_counter()
    if cabi.toolchain() is None:
        print("cabi: gcc, python3-config or Python's headers missing on "
              "this machine: the C ABI was not run on the card")
        return
    t0 = time.perf_counter()
    lib_path = cabi.build_library()
    suite = cabi.build_program(os.path.join(ROOT, "csrc",
                                            "test_veles_simd.c"))
    demo = cabi.build_program(os.path.join(ROOT, "examples",
                                           "c_matched_filter.c"))
    build_s = time.perf_counter() - t0
    # the suite (all 17 families) and the example, side by side, on the
    # card: no VELES_SIMD_PLATFORM
    env = cabi.program_env()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for p in (suite, demo)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CABI_SUITE_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run_s = time.perf_counter() - t0
    (rc, out, err), (drc, dout, derr) = outs
    summary = [ln for ln in out.splitlines() if "failures" in ln]
    check(rc == 0 and "0 failures" in out
          and f"backend: torch:cuda:{kind}" in out,
          f"cabi: the C suite on the card: rc {rc}, {summary}, "
          f"{out[-1500:]} {err[-2500:]}")
    check(drc == 0 and "oracle peak agrees: yes" in dout,
          f"cabi: the C example on the card: rc {drc}, {dout[-800:]} "
          f"{derr[-2500:]}")
    print(f"cabi suite: csrc/test_veles_simd.c unchanged against "
          f"{os.path.relpath(lib_path, ROOT)}, 17 families, "
          f"{summary[-1]}, backend torch:cuda:{kind} | "
          f"examples/c_matched_filter.c: oracle peak agrees | gcc "
          f"{build_s:.1f} s, both programs {run_s:.1f} s side by side")

    # the C entries, through C, on NumPy buffers
    t0 = time.perf_counter()
    lib = cabi.load(lib_path)
    check(lib.veles_simd_init(None) == 0,
          f"cabi: veles_simd_init: {lib.veles_simd_last_error()}")
    backend = lib.veles_simd_backend().decode()
    check(backend == f"torch:cuda:{kind}", f"cabi: backend {backend}")
    init_s = time.perf_counter() - t0

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def c_call(fn):
        rc = fn()
        check(rc == 0, f"cabi: C call failed: {lib.veles_simd_last_error()}")

    x_head = rng.randn(N_HEAD).astype(np.float32)
    h_head = rng.randn(K_HEAD).astype(np.float32)
    y_head = np.zeros(N_HEAD + K_HEAD - 1, np.float32)
    c_handle = lib.convolve_initialize(N_HEAD, K_HEAD, 0)
    check(c_handle is not None, "cabi: convolve_initialize")
    py_handle = cv.convolve_initialize(N_HEAD, K_HEAD)
    x_st = rng.randn(N_ST).astype(np.float32)
    frames = 1 + (N_ST - L_ST) // HOP_ST
    spec = np.zeros((frames, L_ST // 2 + 1, 2), np.float32)
    x_2d = rng.randn(N_2D, N_2D).astype(np.float32)
    h_2d = rng.randn(K_2D, K_2D).astype(np.float32)
    y_2d = np.zeros((N_2D + K_2D - 1,) * 2, np.float32)
    img = rng.randn(N_2D, N_2D).astype(np.float32)
    bands = [np.zeros((N_2D // 2, N_2D // 2), np.float32)
             for _ in range(4)]
    P = wv.ExtensionType.PERIODIC
    st = sp.stft_na(x_st, L_ST, HOP_ST)
    dwt2 = wv.wavelet_apply2d("daub", 8, P, img, simd=False)
    entries = (
        ("convolve", f"handle {N_HEAD}x{K_HEAD} auto", "overlap_save", 2,
         lambda: c_call(lambda: lib.convolve(c_handle, fp(x_head),
                                             fp(h_head), fp(y_head))),
         lambda: cv.convolve(py_handle, x_head, h_head).cpu(),
         lambda: rel_err(y_head, fft_conv64(x_head, h_head))),
        ("stft", f"{N_ST} samples {L_ST}/{HOP_ST}", "stft", 1,
         lambda: c_call(lambda: lib.stft(1, fp(x_st), N_ST, L_ST, HOP_ST,
                                         None, fp(spec))),
         lambda: sp.stft(x_st, L_ST, HOP_ST).cpu(),
         lambda: crel_err(spec[..., 0] + 1j * spec[..., 1], st)),
        ("convolve2d", f"{N_2D}^2 {K_2D}x{K_2D}", "filter_2d", 1,
         lambda: c_call(lambda: lib.convolve2d(1, fp(x_2d), N_2D, N_2D,
                                               fp(h_2d), K_2D, K_2D,
                                               fp(y_2d))),
         lambda: cv2.convolve2d(x_2d, h_2d).cpu(),
         lambda: rel_err(y_2d, conv2d64(x_2d, h_2d))),
        ("wavelet_apply2d", f"{N_2D}^2 daub8 periodic", "filter_bank", 2,
         lambda: c_call(lambda: lib.wavelet_apply2d(
             1, 0, 8, 0, fp(img), N_2D, N_2D, *map(fp, bands))),
         lambda: [b.cpu() for b in wv.wavelet_apply2d("daub", 8, P, img)],
         lambda: max(rel_err(b, w) for b, w in zip(bands, dwt2))),
    )
    for name, shape, kernel, want_launches, c_fn, py_fn, err_fn in entries:
        ck.reset_launches()
        c_fn()
        launches = dict(ck.LAUNCHES)
        err = err_fn()
        check(launches[kernel] == want_launches
              and sum(launches.values()) == want_launches,
              f"cabi {name}: launches {launches}, want {kernel} "
              f"{want_launches}")
        check(err <= ORACLE_TOL, f"cabi {name}: rel err {err:.3e}")
        c_ms = bm.host_time(c_fn, repeats=CABI_REPEATS) * 1e3
        py_ms = bm.host_time(py_fn, repeats=CABI_REPEATS) * 1e3
        print(f"cabi {name} ({shape}) through C: {kernel} x "
              f"{launches[kernel]}, rel err {err:.2e} <= {ORACLE_TOL:g} "
              f"vs float64 | host ms from NumPy buffers, result in host "
              f"memory: C {c_ms:.3f}, Python {py_ms:.3f} "
              f"(best of {CABI_REPEATS})")
    lib.convolve_finalize(c_handle)
    print(f"cabi: phase {time.perf_counter() - t_phase:.1f} s (bridge "
          f"init in this process {init_s:.1f} s) | card {smi}")


# the artifacts phase: a fresh process of the warm pack, and of a stale one
ARTIFACT_CHILD_TIMEOUT_S = 300
ARTIFACT_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from veles.simd_tpu_torch import obs, serve
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.runtime import artifacts as art
from veles.simd_tpu_torch.utils.config import set_config
import chip_smoke as cs

set_config(device="cuda")
obs.enable()
root = art.enable_persistent_compile_cache()    # $VELES_SIMD_CACHE_DIR
with serve.Server(workers=1, obs_port=-1) as srv:
    report = srv.stats()["artifact_preload"]
out = {"preload": report, "root": root,
       "stale": obs.counter_value("artifact_stale", op="kernels",
                                  route="cuda"),
       "placed": sorted(os.listdir(root)) if os.path.isdir(root) else []}
if sys.argv[2] == "headline":
    rng = np.random.RandomState(cs.SEED)
    x = rng.randn(cs.N_HEAD).astype(np.float32)
    h = rng.randn(cs.K_HEAD).astype(np.float32)
    handle = cv.convolve_initialize(cs.N_HEAD, cs.K_HEAD)
    ck.reset_launches()
    y = cv.convolve(handle, x, h).cpu().numpy()
    out["launches"] = dict(ck.LAUNCHES)
    out["err"] = cs.rel_err(y, cs.fft_conv64(x, h))
snap = obs.snapshot()
out["compile"] = {c["name"]: c["value"] for c in snap["counters"]
                  if c["name"].startswith("compile.")}
out["nvcc_s"] = sum(h["sum"] for h in snap["histograms"]
                    if h["name"] == "compile.backend_compile_secs")
out["library_loaded"] = ck._lib is not None
print("RESULT " + json.dumps(out), flush=True)
"""


def spawn_artifact_child(mode, env):
    """Start ``ARTIFACT_CHILD`` in ``mode`` (``headline``: start a
    ``serve.Server``, then run the headline convolution; ``start``:
    start the server and stop before any kernel) with ``env``; returns
    the process and its spawn time."""
    import subprocess

    return (subprocess.Popen([sys.executable, "-c", ARTIFACT_CHILD, ROOT,
                              mode], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env,
                             cwd=ROOT),
            time.perf_counter())


def collect_artifact_child(proc, t0, mode):
    """The child's result and the seconds from its spawn to its result
    line; the child is waited for (or killed)."""
    result, spawn_s, tail = None, None, []
    try:
        for line in proc.stdout:
            if line.startswith("RESULT "):
                spawn_s = time.perf_counter() - t0
                result = json.loads(line[len("RESULT "):])
            else:
                tail = (tail + [line])[-40:]
        proc.wait(timeout=ARTIFACT_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0 and result is not None,
          f"artifacts {mode} child: rc {proc.returncode}, "
          f"{''.join(tail)[-2500:]}")
    return result, spawn_s


def artifact_child(mode, env):
    """Run one ``ARTIFACT_CHILD`` alone: its result and its seconds
    from spawn to result."""
    return collect_artifact_child(*spawn_artifact_child(mode, env), mode)


def artifacts_phase(ck, smi, build_s, build_compiles):
    """The warm pack: the library this process loaded packed in a
    private ``on`` store; a fresh process with an empty build root and
    the store ``readonly`` preloads it at ``serve.Server.start()`` and
    runs the headline with no nvcc; the MANIFEST's device stamp doctored,
    a fresh process places nothing and counts ``artifact_stale``."""
    import hashlib
    import tempfile

    from veles.simd_tpu_torch.runtime import artifacts as art

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="artifacts-",
                            dir=os.path.join(ROOT, "build"))
    try:
        pack = os.path.join(work, "pack")
        t0 = time.perf_counter()
        with art.private_artifact_store(pack) as store, \
                art.artifacts_mode_override("on"):
            check(art.store_kernel_library() == "stored",
                  "artifacts: packing the loaded library")
            keys = store.keys()
        pack_s = time.perf_counter() - t0
        check(keys == ["kernels|" + ck._build_dir().name],
              f"artifacts: pack keys {keys}")

        def snapshot(d):
            return {name: hashlib.sha256(open(os.path.join(d, name), "rb")
                                         .read()).hexdigest()
                    for name in sorted(os.listdir(d))}

        before = snapshot(pack)
        size = sum(os.path.getsize(os.path.join(pack, n)) for n in before)
        with open(os.path.join(pack, art.MANIFEST_NAME)) as f:
            stamp = json.load(f)["device"]
        print(f"artifacts pack: {keys[0]} ({size} bytes with its "
              f"MANIFEST, device stamp {stamp!r}) in {pack_s * 1e3:.1f} ms")

        # the stale pack: a copy whose MANIFEST's device stamp names
        # another card
        stale_pack = os.path.join(work, "stale_pack")
        shutil.copytree(pack, stale_pack)
        path = os.path.join(stale_pack, art.MANIFEST_NAME)
        with open(path) as f:
            manifest = json.load(f)
        manifest["device"] = "NVIDIA B200 sm_100"
        with open(path, "w") as f:
            json.dump(manifest, f)
        # the two children side by side (the stale one stops before any
        # kernel); tools/cold_start_torch.py times a child alone
        env = dict(os.environ, VELES_SIMD_ARTIFACTS="readonly")
        warm_child = spawn_artifact_child("headline", dict(
            env, VELES_SIMD_ARTIFACT_DIR=pack,
            VELES_SIMD_CACHE_DIR=os.path.join(work, "warm_root")))
        stale_child = spawn_artifact_child("start", dict(
            env, VELES_SIMD_ARTIFACT_DIR=stale_pack,
            VELES_SIMD_CACHE_DIR=os.path.join(work, "stale_root")))
        warm, warm_s = collect_artifact_child(*warm_child, "headline")
        stale, stale_s = collect_artifact_child(*stale_child, "start")
        check(warm["preload"]["loaded"] == 1
              and warm["preload"]["failed"] == 0,
              f"artifacts warm child: preload {warm['preload']}")
        check(warm["compile"] == {"compile.cache_hits": 1},
              f"artifacts warm child: compile counters {warm['compile']} "
              "(want one library cache hit, no miss, no nvcc)")
        check(warm["launches"]["overlap_save"] == 2
              and warm["err"] <= ORACLE_TOL,
              f"artifacts warm child: launches {warm['launches']}, rel "
              f"err {warm['err']:.3e}")
        check(snapshot(pack) == before,
              "artifacts: the readonly child changed the store")
        print(f"artifacts warm child (empty build root, "
              f"VELES_SIMD_ARTIFACTS=readonly): preload "
              f"{warm['preload']['loaded']} loaded, "
              f"{warm['preload']['failed']} failed | compile counters "
              f"{warm['compile']} (no nvcc) | headline "
              f"{N_HEAD}x{K_HEAD} overlap_save x "
              f"{warm['launches']['overlap_save']}, rel err "
              f"{warm['err']:.2e} | spawn to first result {warm_s:.2f} s "
              f"(beside the stale child) | store unchanged")
        check(stale["preload"]["loaded"] == 0 and stale["stale"] >= 1
              and stale["placed"] == [] and not stale["library_loaded"]
              and stale["compile"] == {},
              f"artifacts stale child: {stale}")
        print(f"artifacts stale child (device stamp doctored to "
              f"'NVIDIA B200 sm_100'): preload "
              f"{stale['preload']['loaded']} loaded, artifact_stale "
              f"{stale['stale']}, nothing placed, no library loaded, no "
              f"nvcc | {stale_s:.2f} s")
        cold = ("a cache miss: nvcc built the library in it"
                if "compile.backend_compile" in build_compiles
                else "a cache hit (no cold figure in this run)")
        print(f"artifacts cold: this run's build line, {build_s:.1f} s, "
              f"was {cold} | warm child spawn to first result "
              f"{warm_s:.2f} s | phase {time.perf_counter() - t_phase:.1f}"
              f" s | card {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# the suite phase: the JAX suite's full sizes for the rows that reach a
# kernel, --quick for the others (tools/benchmark_suite.py)
def suite_sizes(bs):
    return dict(bs.QUICK, conv_sizes=bs.QUICK["conv_sizes"] + ((1 << 20,
                                                               2047),),
                conv_high=bs.FULL["conv_high"], stft=bs.FULL["stft"])


# the kernel a suite row must have launched, by row name
SUITE_KERNELS = (("convolve 1048576x2047 [overlap_save]", "overlap_save"),
                 ("convolve 1048576x2047 [overlap_save, precision=high]",
                  "overlap_save"),
                 ("convolve batched 256x4096x129", "filter_bank"),
                 ("dwt daub8 64x512", "filter_bank"),
                 ("dwt cascade L3 fused 512x4096", "cascade_bank"),
                 ("conv2d 8x512x512 k=9", "filter_2d"),
                 ("conv2d 64x128x128 k=5", "filter_2d"))


def suite_phase(obs, faults, breaker, smi):
    """``tools/benchmark_suite_torch.py``'s sections (``run`` at
    :func:`suite_sizes`): each row held to its NumPy oracle before it
    is timed (the tool raises otherwise), its line printed with a
    ``suite`` prefix; K1, K2, K3 and K5 launched by their rows, K4 by
    the STFT row where its route is ``cuda_fused``."""
    import contextlib
    import io

    from tools import benchmark_suite_torch as bs

    t_phase = time.perf_counter()
    obs.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = bs.run(suite_sizes(bs), np.random.RandomState(SEED + 4))
    for line in out.getvalue().splitlines():
        print("suite " + line)
    by_name = {r["name"]: r for r in rows}
    launched = set()
    for prefix, kernel in SUITE_KERNELS:
        row = next((r for name, r in by_name.items()
                    if name.startswith(prefix)), None)
        check(row is not None and row["launches"].get(kernel, 0) >= 1,
              f"suite {prefix}: no {kernel} launch "
              f"({row and row['launches']})")
        launched.add(kernel)
    stft = next(r for r in rows if r["name"].startswith("stft "))
    if stft["route"] == "cuda_fused":
        check(stft["launches"].get("stft", 0) >= 1,
              f"suite {stft['name']}: route cuda_fused, launches "
              f"{stft['launches']}")
        launched.add("stft")
    checked = [r for r in rows if r.get("rel_err") is not None]
    check(all(np.isfinite(r["t_peak"]) for r in rows if "t_peak" in r),
          "suite: a chained time did not resolve on the card")
    slowest = sorted((r for r in rows if "wall_s" in r),
                     key=lambda r: -r["wall_s"])[:3]
    print(f"suite: {len(checked)} rows held to their oracles | kernels "
          f"{sorted(launched)} launched by their rows | stft 1024/256 "
          f"route {stft['route']} | slowest rows " + ", ".join(
              f"{r['name']} {r['wall_s']:.1f} s" for r in slowest)
          + f" | phase {time.perf_counter() - t_phase:.1f} s | card {smi}")


# the port's twins of the JAX examples (examples/<name>_torch.py), in
# the README's order
EXAMPLES = ("matched_filter", "sensor_pipeline", "image_filter",
            "wavelet_denoise", "wavelet_multires", "spectral_zoom",
            "kaiser_design", "sharded_longsignal")
# the kernels each example must launch on the card: the 9 x 9 blur, the
# Sobel passes and the 16 x 16 template take K5.  The matched filter's
# stream stage runs the block matmul (as the JAX stage runs XLA's, never
# the Pallas kernel), and the other examples' single rows sit under
# K2's row gate: they launch no kernel of csrc/
EXAMPLE_KERNELS = {"image_filter": ("filter_2d",)}
KERNEL_LABELS = (("K1", "overlap_save"), ("K2", "filter_bank"),
                 ("K3", "cascade_bank"), ("K4", "stft"),
                 ("K5", "filter_2d"))


def kernel_counts(launches):
    """``K1 n K2 n ...``: the launches of each of the five kernels."""
    return " ".join(f"{label} {launches.get(name, 0)}"
                    for label, name in KERNEL_LABELS)


def load_script(*parts):
    """The checkout's script at ``ROOT/<parts>`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        os.path.splitext(parts[-1])[0], os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_example(name):
    """``examples/<name>_torch.py`` as a module (its steps and ``run``)."""
    return load_script("examples", f"{name}_torch.py")


def examples_phase(torch, ck, obs, faults, breaker, smi):
    """Each of the port's examples through its ``run()`` at the JAX
    example's sizes on the card: every check held, the kernels of
    :data:`EXAMPLE_KERNELS` launched, no fault recorded; one line an
    example (its checks, wall seconds, busy ms a block where it times
    a stream, the launches of each kernel), after its own lines."""
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        mod = load_example(name)
        obs.reset()
        lines = []
        t0 = time.perf_counter()
        with ck.count_launches() as launches:
            res = mod.run(emit=lines.append)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in lines:
            print(f"example {name}: {line}")
        checks = res["checks"]
        failed = sorted(k for k, ok in checks.items() if not ok)
        check(not failed, f"examples {name}: checks failed {failed}")
        for kernel in EXAMPLE_KERNELS.get(name, ()):
            check(launches.get(kernel, 0) >= 1,
                  f"examples {name}: no {kernel} launch ({launches})")
        healthy(f"examples {name}", obs, faults, breaker)
        busy = res.get("busy_ms_a_block")
        extra = ""
        if name == "matched_filter":
            extra = (f" | route {res['route']}, launches a block "
                     f"{res['launches_a_block']} | fused "
                     f"{res['fused_blocks_s']:.1f} blocks/s, unfused "
                     f"{res['unfused_blocks_s']:.1f}")
        print(f"examples {name}: checks {len(checks)}/{len(checks)} held "
              f"({', '.join(checks)}) | wall {wall:.2f} s | busy "
              + ("not timed" if busy is None else f"{busy:.4f} ms a block")
              + f" | launches {kernel_counts(launches)}{extra}")
    print(f"examples: {len(EXAMPLES)} examples, every check held | phase "
          f"{time.perf_counter() - t_phase:.1f} s | card {smi}")


# the 2D sweep's batch sizes in the tools phase (the tool's default)
TUNE_ROWS = (1, 8)


def tools_phase(torch, ck, obs, faults, breaker, smi):
    """The port's measuring tools on the card through their functions:
    ``bench_multichip_torch`` at ``--quick`` on 8 shards of ``cuda:0``
    (every row held to ``np.fft`` before it is timed), the
    ``tune_conv2d_torch --quick`` sweep (every candidate held to
    float64, the 2D kernel launched and held within the tolerance in
    every cell its gate admits), and ``profile_overlap_save_torch`` at
    1,048,576 x 2047 (every route held to float64, K1 twice a call)."""
    from tools import bench_multichip_torch as bmc
    from tools import profile_overlap_save_torch as pos
    from tools import tune_conv2d_torch as tc2

    t_phase = time.perf_counter()
    obs.reset()
    lines = []
    t0 = time.perf_counter()
    entries = bmc.run_bench(PAR_SHARDS, None, quick=True,
                            emit=lines.append)
    for line in lines:
        print(f"tools multichip: {line}")
    rows, tail = entries[:-1], entries[-1]
    check(len(rows) == 3 and not any("flagged" in r for r in rows)
          and tail["n_devices"] == PAR_SHARDS
          and tail["distinct_cards"] == 1,
          f"tools multichip: rows {[r['metric'] for r in rows]}, tail "
          f"{tail}")
    healthy("tools multichip", obs, faults, breaker)
    print(f"tools multichip: {len(rows)} rows held to np.fft | "
          + " | ".join(f"{r['metric']} {r['value']:.1f} Ms/s (x"
                       f"{r['vs_baseline']:.2f}) route {r['route']}"
                       for r in rows)
          + f" | {tail['note']} | {time.perf_counter() - t0:.1f} s")

    obs.reset()
    t0 = time.perf_counter()
    results = tc2.sweep(tc2.QUICK["images"], tc2.QUICK["kernels"],
                        TUNE_ROWS, emit=lambda line: print(
                            "tools tune_conv2d: " + line))
    k5 = [(key, c["cands"]["cuda_direct"]) for key, c in results.items()
          if "cuda_direct" in c["cands"]]
    check(k5 and all(c["ok"] and c["launches"] == {"filter_2d": 1}
                     for _, c in k5),
          f"tools tune_conv2d: 2D kernel candidates {k5}")
    check(all(c["winner"] for c in results.values()),
          "tools tune_conv2d: a cell with no valid candidate")
    healthy("tools tune_conv2d", obs, faults, breaker)
    cut, miss, cells = tc2.crossover(results)
    wins = {}
    for c in results.values():
        wins[c["winner"]] = wins.get(c["winner"], 0) + 1
    print(f"tools tune_conv2d: {len(results)} cells, every candidate held "
          f"to float64 | 2D kernel in {len(k5)} cells, 1 launch each, "
          f"max err {max(c['err'] for _, c in k5):.1e} | winners {wins} | "
          f"best direct-vs-fft area cut {cut} ({miss} of {cells} "
          f"misclassified) | {time.perf_counter() - t0:.1f} s")

    obs.reset()
    t0 = time.perf_counter()
    prof = pos.profile(N_HEAD, K_HEAD, emit=lambda line: print(
        "tools profile_overlap_save: " + line))
    by = {r["name"]: r for r in prof}
    check(by["cuda_fused"]["launches"] == {"overlap_save": 2},
          f"tools profile_overlap_save: K1 launches "
          f"{by['cuda_fused']['launches']}, want 2 a call")
    check(all(r["busy_ms"] and r["busy_ms"] >= r["least_work_bound_ms"]
              for r in prof),
          "tools profile_overlap_save: a busy time missing or under its "
          "bound")
    healthy("tools profile_overlap_save", obs, faults, breaker)
    print("tools profile_overlap_save: " + " | ".join(
        f"{r['name']} busy {r['busy_ms']:.4f} ms, "
        f"{r['pct_of_least_work_bound']:.1f}% of the least-work bound, "
        f"launches {r['launches'] or 0}" for r in prof)
        + f" | {time.perf_counter() - t0:.1f} s")
    print(f"tools: multichip, tune_conv2d, profile_overlap_save held | "
          f"phase {time.perf_counter() - t_phase:.1f} s | card {smi}")


def mask_check(ge, mask, p64, x64):
    """``(bits that differ where a neighbour difference is under the
    margin, bits compared)``; fails on any other differing bit: the
    card's mask against the float64 CPU mask, exact wherever
    ``min(|d1|, |d2|) >= TRAIN_MASK_MARGIN * max|filt|``."""
    import torch

    filt = ge._filtered(p64["filter"], x64)
    mask64 = ge._pipeline(p64, x64)[1]
    d1 = (filt[..., 1:-1] - filt[..., :-2]).abs()
    d2 = (filt[..., 1:-1] - filt[..., 2:]).abs()
    sure = torch.ones_like(mask64)
    sure[..., 1:-1] = (torch.minimum(d1, d2)
                       >= TRAIN_MASK_MARGIN * filt.abs().max())
    differ = mask.cpu() != mask64
    check(not bool((differ & sure).any()),
          f"train: {int((differ & sure).sum())} peak-mask bits differ "
          f"clear of the margin")
    return int((differ & ~sure).sum()), int(mask64.numel())


def train_phase(torch, ck, bm, obs, faults, breaker, smi):
    """The flagship step (``graft_entry_torch.py``) on the card:
    ``entry()``'s forward against a float64 CPU run of the same
    ``_pipeline`` (the mask exact clear of the margin), ten
    ``train_step``s each against a float64 CPU autograd step from the
    same parameters and the loss lower after them, one
    ``sharded_train_step`` at full width on 8 shards of ``cuda:0``
    against the single-card step, then ``dryrun_multichip(8)`` with
    every check; the step's busy and chained ms, idle share, kernels a
    step, and its K1-K5 launches (none: it reaches no csrc kernel)."""
    import contextlib
    import io

    from veles.simd_tpu_torch import parallel as par

    ge = load_script("graft_entry_torch.py")
    t_phase = time.perf_counter()
    obs.reset()

    def f64(params):
        return {k: v.detach().cpu().double() for k, v in params.items()}

    fn, (params, x) = ge.entry()
    x64 = x.cpu().double()
    p64 = f64(params)
    rng = np.random.RandomState(SEED + 4)
    target = torch.as_tensor(rng.randn(
        x.shape[0], params["proj"].shape[0]).astype(np.float32),
        device=x.device)
    t64 = target.cpu().double()
    with ck.count_launches() as launches:
        feats, mask = fn(params, x)
        torch.cuda.synchronize()
        err_f = rel_err(feats.cpu(), ge._pipeline(p64, x64)[0])
        check(err_f <= ORACLE_TOL, f"train forward: {err_f:.2e} of max|"
              f"feats| against float64")
        loose, bits = mask_check(ge, mask, p64, x64)
        print(f"train forward: entry() {tuple(x.shape)} x "
              f"{tuple(params['filter'].shape)} taps -> feats "
              f"{tuple(feats.shape)}, mask {tuple(mask.shape)} | err "
              f"{err_f:.2e} of max|feats| vs float64 | mask exact clear "
              f"of {TRAIN_MASK_MARGIN:g} x max|filt|, {loose} of {bits} "
              f"bits differ under it | card {smi}")

        losses, errs, steps = [], [], []
        p = params
        for _ in range(TRAIN_STEPS):
            q64 = f64(p)
            loss, new = ge.train_step(p, x, target)
            loss64, new64 = ge.train_step(q64, x64, t64)
            errs.append(max([abs(float(loss) - float(loss64))
                             / abs(float(loss64))]
                            + [rel_err(new[k].cpu(), new64[k])
                               for k in new]))
            steps.append(max(rel_err(q64[k] - new[k].cpu().double(),
                                     q64[k] - new64[k]) for k in new))
            check(errs[-1] <= ORACLE_TOL,
                  f"train step {len(losses)}: {errs[-1]:.2e} against "
                  f"the float64 step")
            losses.append(float(loss))
            p = new
        with torch.no_grad():
            final = float(ge.loss_fn(p, x, target))
        check(final < losses[0], f"train: loss {losses[0]:.6f} -> "
              f"{final:.6f} after {TRAIN_STEPS} steps")
        print(f"train steps: {TRAIN_STEPS} SGD steps at lr 0.01 | loss "
              + " ".join(f"{v:.6f}" for v in losses)
              + f" -> {final:.6f} | worst loss/param err {max(errs):.2e} "
              f"vs float64 | worst step (lr x grad) err {max(steps):.2e} "
              f"of its max | card {smi}")

        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = par.make_mesh({"dp": 2, "sp": 2, "tp": 2},
                             devices=[dev] * PAR_SHARDS)
        t0 = time.perf_counter()
        loss_m, new_m = ge.sharded_train_step(params, x, target, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss1, new1 = ge.train_step(params, x, target)
        err_m = max([abs(float(loss_m) - float(loss1)) / abs(float(loss1))]
                    + [rel_err(new_m[k].cpu(), new1[k].cpu())
                       for k in new1])
        check(err_m <= PARITY_TOL, f"train sharded: {err_m:.2e} against "
              f"the single-card step")
        print(f"train sharded: sharded_train_step {mesh} at full width | "
              f"loss {float(loss_m):.6f} | err {err_m:.2e} of max vs the "
              f"single-card step | wall {wall:.3f} s (first call) | "
              f"card {smi}")
    check(not launches, f"train: the step launched a csrc kernel: "
          f"{launches}")

    state = [params]

    def step():
        state[0] = ge.train_step(state[0], x, target)[1]

    busy, kernels = bm.device_profile(step)
    chained = bm.device_time_ms(step)
    with ck.count_launches() as timed:
        step()
        torch.cuda.synchronize()
    check(not timed, f"train: the timed step launched {timed}")
    print(f"train time: busy {busy:.4f} ms a step (CUPTI) | chained "
          f"{chained:.4f} ms a step (CUDA events) | idle share "
          f"{max(0.0, 1.0 - busy / chained):.3f} | kernels {kernels:.0f} "
          f"a step | launches {kernel_counts(launches)} | card {smi}")

    out = io.StringIO()
    t0 = time.perf_counter()
    with ck.count_launches() as dry, contextlib.redirect_stdout(out):
        loss_d = ge.dryrun_multichip(PAR_SHARDS)
        torch.cuda.synchronize()
    line = out.getvalue().strip().splitlines()[-1]
    check(np.isfinite(loss_d) and line.endswith(" ok"),
          f"train dryrun: {line}")
    healthy("train", obs, faults, breaker)
    print(f"train dryrun: {line} | every check held | "
          f"{time.perf_counter() - t0:.1f} s | launches "
          f"{kernel_counts(dry)}")
    print(f"train: forward, {TRAIN_STEPS} steps, the sharded step and "
          f"the dry run held | phase {time.perf_counter() - t_phase:.1f} "
          f"s | card {smi}")


# the devtools phase: the orders it regenerates and the DWT it runs
# each through K2 (rows x samples, periodic extension)
DEVTOOLS_ORDERS = (("daub", 8), ("sym", 8), ("coif", 6))
DEVTOOLS_ROWS, DEVTOOLS_N = 512, 4096
# a regenerated filter's DWT against the committed filter's, relative
# to max|y| (the rows differ by at most their drift bound, 1e-9 here,
# far under float32's rounding of the taps)
DEVTOOLS_FILTER_TOL = 1e-6


def devtools_phase(torch, ck, obs, faults, breaker, smi):
    """The port's developer gate on the card's machine:
    ``tools/lint_torch.py`` on the checkout (rc 0) and
    ``tools/gen_wavelet_tables_torch.py --orders daub8,sym8,coif6
    --derived`` into a scratch table, in two processes at once; each
    regenerated row held to the committed one within its drift bound;
    then a 512 x 4096 periodic DWT with each regenerated filter through
    K2 (``filter_bank_cuda``, one launch a call), held within 1e-6 of
    max|y| to the same DWT with the committed filter
    (``wavelet.wavelet_apply``, K2 too) and within 1e-4 to float64."""
    import subprocess
    import tempfile

    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops import wavelet_coeffs as wc

    gen = load_script("tools", "gen_wavelet_tables_torch.py")
    t_phase = time.perf_counter()
    obs.reset()
    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "derived.npz")
        keys = [f"{fam}{order}" for fam, order in DEVTOOLS_ORDERS]
        procs = {
            "lint": subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tools",
                                              "lint_torch.py")],
                cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True),
            "tables": subprocess.Popen(
                [sys.executable, os.path.join(
                    ROOT, "tools", "gen_wavelet_tables_torch.py"),
                 "--orders", ",".join(keys), "--derived",
                 "--out", table, "--reference", tmp],
                cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)}
        outs = {}
        try:
            for name, proc in procs.items():
                outs[name] = proc.communicate(timeout=120)[0]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tools_s = time.perf_counter() - t_phase
        lint_tail = outs["lint"].strip().splitlines()[-1:] or [""]
        check(procs["lint"].returncode == 0,
              f"devtools lint: rc {procs['lint'].returncode}: "
              f"{outs['lint'][-2000:]}")
        print(f"devtools lint: tools/lint_torch.py rc 0 | {lint_tail[0]} "
              f"| card {smi}")
        check(procs["tables"].returncode == 0,
              f"devtools tables: rc {procs['tables'].returncode}: "
              f"{outs['tables'][-2000:]}")
        derived = gen.load_table(table)
    committed = gen.load_table(wc._TABLE_PATH)
    drifts = []
    for family, order in DEVTOOLS_ORDERS:
        key = f"{family}{order}"
        bound = gen.published_drift_bound(order, family)
        drift = float(np.max(np.abs(derived[key] - committed[key])))
        check(drift < bound, f"devtools tables: {key} drifts {drift:.2e} "
              f"from the committed row, bound {bound:.0e}")
        drifts.append(f"{key} {drift:.1e} < {bound:.0e}")
    print(f"devtools tables: gen_wavelet_tables_torch.py --orders "
          f"{','.join(keys)} --derived rc 0 | derived vs "
          f"committed: {' | '.join(drifts)} | both tools {tools_s:.1f} s "
          f"(in parallel)")

    rng = np.random.RandomState(SEED + 5)
    x_np = rng.randn(DEVTOOLS_ROWS, DEVTOOLS_N).astype(np.float32)
    x = torch.as_tensor(x_np, device="cuda")
    half = DEVTOOLS_N // 2
    for family, order in DEVTOOLS_ORDERS:
        key = f"{family}{order}"
        lo64 = derived[key]
        hi64 = wc.qmf_highpass(lo64)
        taps = torch.as_tensor(np.stack([hi64, lo64]).astype(np.float32),
                               device="cuda")
        x_ext = wv._extend(x, "periodic", order).contiguous()
        with ck.count_launches() as regen:
            got = ck.filter_bank_cuda(x_ext, taps, 2, 1, half)
            torch.cuda.synchronize()
        check(regen == {"filter_bank": 1},
              f"devtools dwt {key}: launches {regen}, want K2 once")
        with ck.count_launches() as comm:
            want = wv.wavelet_apply(family, order, "periodic", x)
            torch.cuda.synchronize()
        check(comm == {"filter_bank": 1},
              f"devtools dwt {key}: the committed filter's DWT launched "
              f"{comm}")
        got_np = np.stack([g.cpu().numpy() for g in got])
        want_np = np.stack([w.cpu().numpy() for w in want])
        err_c = rel_err(got_np, want_np)
        ext64 = np.concatenate([x_np, x_np[:, :order]], axis=1).astype(
            np.float64)
        win = np.lib.stride_tricks.sliding_window_view(
            ext64, order, axis=1)[:, ::2][:, :half]
        want64 = np.stack([win @ hi64, win @ lo64])
        err_64 = rel_err(got_np, want64)
        check(err_c <= DEVTOOLS_FILTER_TOL,
              f"devtools dwt {key}: {err_c:.2e} of max|y| against the "
              f"committed filter's DWT")
        check(err_64 <= ORACLE_TOL,
              f"devtools dwt {key}: {err_64:.2e} of max|y| against "
              f"float64")
        print(f"devtools dwt {key}: {DEVTOOLS_ROWS} x {DEVTOOLS_N} "
              f"periodic, the regenerated filter through K2 "
              f"(filter_bank_cuda, {regen['filter_bank']} launch) | vs "
              f"the committed filter (wavelet_apply, K2 "
              f"{comm['filter_bank']}) {err_c:.2e} of max|y| | vs "
              f"float64 {err_64:.2e} | card {smi}")
    healthy("devtools", obs, faults, breaker)
    print(f"devtools: lint rc 0, {len(DEVTOOLS_ORDERS)} rows within "
          f"their bounds, {len(DEVTOOLS_ORDERS)} DWTs through K2 held | "
          f"phase {time.perf_counter() - t_phase:.1f} s | card {smi}")


# past this many seconds of chip_smoke the chaos phase runs the
# subprocess and scale campaigns at --smoke (the run's limit is 1200 s)
CHAOS_SMOKE_AFTER_S = 700.0

CHAOS_CAMPAIGNS = (("single", []), ("replicas thread", ["--replicas"]),
                   ("replicas subprocess", ["--replicas", "--spawn",
                                            "subprocess"]),
                   ("scale", ["--scale"]))


def chaos_phase(obs, faults, breaker, smi, elapsed_s):
    """``tools/chaos_torch.py``'s four campaigns in this process, at
    the JAX tool's default sizes (``--smoke`` for the subprocess and
    scale ones past :data:`CHAOS_SMOKE_AFTER_S`); any invariant that
    does not hold fails the phase.  The state the campaigns leave
    (breakers, fault history, telemetry) is reset after them."""
    from tools import chaos_torch

    t_phase = time.perf_counter()
    smoke_late = elapsed_s > CHAOS_SMOKE_AFTER_S
    work = os.path.join(ROOT, "build", "chaos_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        for label, argv in CHAOS_CAMPAIGNS:
            late = smoke_late and label in ("replicas subprocess", "scale")
            args = chaos_torch.parse_args(
                argv + (["--smoke"] if late else []) + [
                    "--details", os.path.join(
                        work, label.replace(" ", "_") + ".json")])
            t0 = time.perf_counter()
            invariants, rows, _ = chaos_torch.campaign(args)
            took = time.perf_counter() - t0
            held = sum(1 for ok in invariants.values() if ok)
            print(f"chaos {label}{' (--smoke)' if late else ''}: "
                  f"{held}/{len(invariants)} invariants | " + " | ".join(
                      f"{r['metric']} {r['value']}" for r in rows)
                  + f" | {took:.1f} s")
            bad = sorted(k for k, ok in invariants.items() if not ok)
            check(not bad, f"chaos {label}: invariants failed {bad}")
    finally:
        faults.set_fault_plan(None)
        shutil.rmtree(work, ignore_errors=True)
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    print(f"chaos: 4 campaigns green | phase "
          f"{time.perf_counter() - t_phase:.1f} s | card {smi}")


# bench_torch.py's configs the bench phase runs: 4 (the headline),
# 5 (the DWT) and 6 (the STFT routes)
BENCH_CONFIGS = ("bench_convolve_1m", "bench_dwt", "bench_stft")


def bench_phase(obs, faults, breaker, smi):
    """``bench_torch.py``'s configs 4, 5 and 6 through their functions
    (each raises when its own check against the oracle fails), every
    row finite and on its kernels, then the port's correctness smoke
    over every family; the healthy paths record no fault."""
    import bench_torch
    from tools import tpu_smoke_torch

    t_phase = time.perf_counter()
    for i, name in enumerate(BENCH_CONFIGS):
        obs.reset()
        t0 = time.perf_counter()
        row = getattr(bench_torch, name)(np.random.RandomState(SEED + i))
        took = time.perf_counter() - t0
        check(all(np.isfinite(row[k]) and row[k] > 0
                  for k in ("value", "baseline")),
              f"bench {name}: row {row}")
        if name == "bench_convolve_1m":
            check(row["oracle_rel_err"] <= bench_torch.HEADLINE_TOL
                  and row["launches"] == {"overlap_save": 2},
                  f"bench headline: {row['oracle_rel_err']:.3e}, "
                  f"launches {row['launches']}")
            roof = row["roofline"]
            extra = (f"busy {row['device_busy_ms']:.4f} ms | direct-form "
                     f"equivalent {roof['pct_of_roofline']:.0f}% of the "
                     f"fp32 peak, {roof['pct_of_least_work_bound']:.1f}% "
                     f"of the least-work bound | launches "
                     f"{row['launches']}")
        elif name == "bench_dwt":
            check(row["launches"].get("filter_bank", 0) >= 1,
                  f"bench dwt: launches {row['launches']}")
            extra = f"launches {row['launches']}"
        else:
            block = row["stft_1m_512_128"]
            check(block["launches"].get("stft", 0) >= 1
                  and np.isfinite(block["msamples_per_s"]),
                  f"bench stft 1M x 512/128: {block}")
            extra = (f"route {row['stft_route']} (xla_fft "
                     f"{row['xla_fft_msamples_per_s']:.1f} Ms/s) | 1M x "
                     f"512/128 {block['route']} "
                     f"{block['msamples_per_s']:.1f} Ms/s (xla_fft "
                     f"{block['xla_fft_msamples_per_s']:.1f}), launches "
                     f"{block['launches']}")
        healthy(f"bench {name}", obs, faults, breaker)
        print(f"bench: config {row['metric']}: {row['value']:.1f} "
              f"{row['unit']} (x{row['value'] / row['baseline']:.1f} over "
              f"the NumPy oracle's {row['baseline']:.1f}) | {extra} | "
              f"{took:.1f} s | card {smi}")
    obs.reset()
    lines = []
    ok = tpu_smoke_torch.run_smoke(emit=lines.append)
    for line in lines:
        print("bench smoke: " + line)
    failed = [line for line in lines if not line.endswith(" ok")]
    check(ok and len(lines) == len(tpu_smoke_torch.FAMILIES)
          and not failed, f"bench smoke: {failed or lines}")
    healthy("bench smoke", obs, faults, breaker)
    print(f"bench: {len(lines)} smoke families passed | phase "
          f"{time.perf_counter() - t_phase:.1f} s | card {smi}")


def autotune_phase(torch, rng, obs, ck, smi):
    """The measured autotuner on the card (``VELES_SIMD_AUTOTUNE=on``
    in this thread, a private tune cache in a temporary directory, the
    default CUDA-event probe timer): each main-path geometry probed
    once, its winner held to the float64 oracle; the same calls again
    as cache hits (no probe, no launch but the winner's kernel); the
    pack reloaded ``readonly`` (same winners, zero probes); the pack
    restamped for another device (every lookup misses, the static
    priors); a CPU operand in this card process (no probe, nothing
    stored); and ``off`` bit-identical to a run with no cache."""
    import tempfile

    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.runtime import precision as prx
    from veles.simd_tpu_torch.runtime import routing

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    obs.enable()
    routing.set_probe_timer(None)

    def cuda(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def host(y):
        return y.cpu().numpy() if isinstance(y, torch.Tensor) else y

    # the decision event each family's dispatch records (probes record
    # none), and its name for a family route where the two differ
    decision_of = {"convolve.os": "convolve_os_route",
                   "convolve.direct": "convolve_direct_route",
                   "stft": "stft_route", "istft": "istft_route",
                   "convolve2d": "convolve2d", "wavelet": "wavelet_apply",
                   "matrix.gemm": "matrix_precision_route",
                   "hilbert": "hilbert_route",
                   "morlet_cwt": "morlet_cwt_route"}
    route_of = {("convolve2d", "direct_cuda"): "direct"}

    # (label, family, call, float64 oracle, compare) per geometry; the
    # operands live on the card, the oracles are computed once
    geoms = []

    def add(label, fam, call, oracle, cmp=crel_err):
        geoms.append((label, fam, call, oracle, cmp))

    x_os = rng.randn(N_HEAD).astype(np.float32)
    h_os = rng.randn(K_HEAD).astype(np.float32)
    hd_os = cv.convolve_overlap_save_initialize(N_HEAD, K_HEAD)
    xo, ho = cuda(x_os), cuda(h_os)
    add(f"convolve.os {N_HEAD}x{K_HEAD}", "convolve.os",
        lambda: cv.convolve(hd_os, xo, ho), lambda: fft_conv64(x_os, h_os))
    x_d = rng.randn(ROWS_FB, N_FB).astype(np.float32)
    h_d = rng.randn(K_FB).astype(np.float32)
    xd, hdd = cuda(x_d), cuda(h_d)
    add(f"convolve.direct {ROWS_FB}x{N_FB}x{K_FB}", "convolve.direct",
        lambda: cv.convolve_simd(xd, hdd), lambda: fft_conv64(x_d, h_d))
    # the short rows where K1 once lost to a direct form
    for rows, n, k in ((3, 5000, 256), (70000, 8, 256),
                       (1, 1 << 20, 300)):
        xs_np = rng.randn(rows, n).astype(np.float32)
        hs_np = rng.randn(k).astype(np.float32)
        xs, hs = cuda(xs_np), cuda(hs_np)
        want = (lambda a=xs_np, b=hs_np: fft_conv64(a, b))
        add(f"convolve.direct {rows}x{n}x{k}", "convolve.direct",
            lambda a=xs, b=hs: cv.convolve_simd(a, b), want)
        if k < n // 2:      # the overlap-save handle's contract
            hd = cv.convolve_overlap_save_initialize(n, k)
            add(f"convolve.os {rows}x{n}x{k}", "convolve.os",
                lambda a=xs, b=hs, hd=hd: cv.convolve(hd, a, b), want)
    x_st = rng.randn(N_ST).astype(np.float32)
    xst = cuda(x_st)
    add(f"stft {N_ST} {L_ST}/{HOP_ST}", "stft",
        lambda: sp.stft(xst, L_ST, HOP_ST),
        lambda: sp.stft_na(x_st, L_ST, HOP_ST))
    x_is = rng.randn(ROWS_BS, N_BS).astype(np.float32)
    spec_is = torch.as_tensor(sp.stft_na(x_is, L_ST, HOP_ST).astype(
        np.complex64), device=dev)
    core = slice(L_ST - HOP_ST, N_BS - L_ST + HOP_ST)
    add(f"istft {ROWS_BS}x{N_BS} {L_ST}/{HOP_ST}", "istft",
        lambda: sp.istft(spec_is, N_BS, L_ST, HOP_ST),
        lambda: sp.istft_na(spec_is.cpu().numpy(), N_BS, L_ST, HOP_ST),
        lambda got, want: crel_err(got[:, core], want[:, core]))
    x_2d = rng.randn(IMGS_2D, N_2D, N_2D).astype(np.float32)
    h_2d = rng.randn(K_2D, K_2D).astype(np.float32)
    x2, h2 = cuda(x_2d), cuda(h_2d)
    add(f"convolve2d {IMGS_2D}x{N_2D}^2 {K_2D}x{K_2D}", "convolve2d",
        lambda: cv2.convolve2d(x2, h2), lambda: conv2d64(x_2d, h_2d))
    x_wv = rng.randn(ROWS_WV, N_WV).astype(np.float32)
    xw = cuda(x_wv)
    P = wv.ExtensionType.PERIODIC
    add(f"wavelet {ROWS_WV}x{N_WV} daub8", "wavelet",
        lambda: torch.stack(wv.wavelet_apply("daub", 8, P, xw)),
        lambda: np.stack(wv.wavelet_apply_na("daub", 8, P, x_wv)))
    a_g = cuda(rng.randn(N_GEMM2, N_GEMM2))
    b_g = cuda(rng.randn(N_GEMM2, N_GEMM2))
    add(f"matrix.gemm {N_GEMM2}^3", "matrix.gemm",
        lambda: mx.matrix_multiply(a_g, b_g),
        lambda: (a_g.double() @ b_g.double()).cpu().numpy())
    for n_h in (1024, 65536):
        x_h = rng.randn(n_h).astype(np.float32)
        xh = cuda(x_h)
        add(f"hilbert {n_h}", "hilbert",
            lambda a=xh: sp.hilbert(a), lambda a=x_h: sp.hilbert_na(a))
    x_cw = rng.randn(ROWS_CWT, N_CWT).astype(np.float32)
    scales = np.geomspace(2.0, 512.0, SCALES_CWT)
    xc = cuda(x_cw)
    add(f"morlet_cwt {ROWS_CWT}x{N_CWT} {SCALES_CWT} scales",
        "morlet_cwt", lambda: sp.morlet_cwt(xc, scales),
        lambda: sp.morlet_cwt_na(x_cw, scales))

    def run(i):
        """Geometry i's call: (output on the host, its family's pick or
        None, launches by kernel, autotune events)."""
        label, fam, call, _, _ = geoms[i]
        obs.reset()
        ck.reset_launches()
        out = host(call())
        torch.cuda.synchronize()
        mine = [route_of.get((fam, e["decision"]), e["decision"])
                for e in obs.events() if e["op"] == decision_of[fam]
                and e["decision"] != "autotune_fft"]
        check(len(mine) <= 1, f"autotune {label}: {len(mine)} {fam} "
              f"dispatches in one call")
        return (out, mine[0] if mine else None,
                {k: v for k, v in ck.LAUNCHES.items() if v},
                [e for e in obs.events() if e["op"] == "autotune"])

    def counted(name, fam):
        """``name`` summed over the family's route labels."""
        return sum(c["value"] for c in obs.snapshot()["counters"]
                   if c["name"] == name
                   and c["labels"].get("family") == fam)

    oracles = [oracle() for _, _, _, oracle, _ in geoms]
    tmp = tempfile.mkdtemp(prefix="veles_autotune_")
    pack = os.path.join(tmp, "pack.json")
    try:
        # 1. probe each geometry once
        first = []
        with routing.private_tune_cache(pack) as cache, \
                routing.autotune_mode_override("on"):
            for i, (label, fam, _, _, cmp) in enumerate(geoms):
                out, pick, _, evs = run(i)
                check(pick is not None, f"{label}: no {fam} selection")
                if evs:
                    (ev,) = evs
                    check(ev["decision"] == pick, f"{label}: event "
                          f"{ev['decision']} but dispatched {pick}")
                    prior, timings = ev["static"], ev["timings"]
                    key = ev["key"]
                    # a candidate that failed its probe would lose to
                    # the others unseen: every one must have a time
                    check("=failed" not in timings,
                          f"autotune {label}: a probe failed: {timings}")
                else:
                    prior, timings, key = pick, "1 candidate, no probe", "-"
                troubles = {name: counted(name, fam) for name in (
                    "autotune_probe_error", "autotune_probe_transient",
                    "autotune_probe_retry", "autotune_inconclusive")}
                check(not any(troubles.values()),
                      f"autotune {label}: probe trouble {troubles}")
                tol = (prx.ERROR_BUDGETS["bf16_comp"]
                       if pick.endswith("bf16_comp") else ORACLE_TOL)
                err = cmp(out, oracles[i])
                check(err <= tol, f"autotune {label}: winner {pick} rel "
                      f"err {err:.3e} > {tol}")
                first.append((pick, prior, bool(evs)))
                flip = " (differs from the prior)" if pick != prior else ""
                print(f"autotune: {fam} | {label} | key {key} | prior "
                      f"{prior} | winner {pick}{flip} | probe {timings} | "
                      f"rel {err:.2e}")
            probed = [i for i, (_, _, p) in enumerate(first) if p]
            check(len(probed) == len(cache.entries()),
                  f"{len(probed)} probe rounds but "
                  f"{len(cache.entries())} pack entries")
            # 2. the same calls again: cache hits, no probe, no launch
            # but the winner's kernel
            hits = []
            for i, (label, fam, _, _, _) in enumerate(geoms):
                out, pick, launched, evs = run(i)
                check(pick == first[i][0] and not evs,
                      f"{label}: second call picked {pick}, probed "
                      f"{len(evs)}")
                if first[i][2]:
                    check(counted("autotune_cache_hit", fam) == 1,
                          f"{label}: no cache hit on the second call")
                kern = KERNEL_OF_ROUTE.get((fam, pick))
                check(set(launched) <= ({kern} if kern else set()),
                      f"{label}: the hit launched {launched} for {pick}")
                hits.append(launched)
            cache.save()
        print(f"autotune: second calls all cache hits, {len(probed)} "
              f"entries | launches per hit call: " + ", ".join(
                  f"{g[0].split()[0]} {h or 'none'}"
                  for g, h in zip(geoms, hits)))
        # 3. the pack reloaded readonly: the same winners, zero probes
        def never(thunk, name):
            raise RuntimeError(f"a readonly reload probed {name}")

        with routing.probe_timer(never), \
                routing.private_tune_cache(pack) as reloaded, \
                routing.autotune_mode_override("readonly"):
            for i, (label, _, _, _, _) in enumerate(geoms):
                out, pick, launched, evs = run(i)
                check(pick == first[i][0] and not evs
                      and launched == hits[i],
                      f"{label}: readonly reload picked {pick}, "
                      f"launched {launched}")
            info = reloaded.info()
        check(info["hits"] == len(probed) and info["stores"] == 0,
              f"readonly reload: {info}")
        print(f"autotune: readonly reload of {pack} | {info['hits']} hits,"
              f" 0 probes, 0 stores, the same winners")
        # 4. the pack restamped for another device: every lookup
        # misses, device_mismatch counted, the static priors
        with open(pack) as f:
            data = json.load(f)
        data["device"] = "TPU v5 lite"
        with open(pack, "w") as f:
            json.dump(data, f)
        with routing.probe_timer(never), \
                routing.private_tune_cache(pack) as foreign, \
                routing.autotune_mode_override("readonly"):
            for i, (label, _, _, _, _) in enumerate(geoms):
                out, pick, _, evs = run(i)
                check(pick == first[i][1] and not evs,
                      f"{label}: a foreign pack steered {pick}")
            info = foreign.info()
        check(info["device_mismatch"] == 1 and info["hits"] == 0
              and info["size"] == 0, f"foreign pack: {info}")
        print(f"autotune: pack restamped 'TPU v5 lite' | device_mismatch "
              f"{info['device_mismatch']}, {info['misses']} misses, 0 hits,"
              " the static priors")
        # a CPU operand in this card process: never probed, never stored
        with routing.private_tune_cache() as own, \
                routing.autotune_mode_override("on"):
            obs.reset()
            y_cpu = sp.hilbert(torch.randn(4, 1024))
            check(y_cpu.device.type == "cpu" and not own.entries()
                  and counted("autotune_device_skip", "hilbert") == 1,
                  f"a CPU operand was tuned under {own.device}")
        # 5. off: bit-identical to a run with no cache at all
        with routing.autotune_mode_override("off"):
            with routing.private_tune_cache(pack):
                bound = [run(i)[0] for i in range(len(geoms))]
            free = [run(i)[0] for i in range(len(geoms))]
        for (label, *_), a, b in zip(geoms, bound, free):
            check(np.array_equal(a, b), f"{label}: off differs with a "
                  "pack bound")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    flips = [f"{g[0]}: {w} over {p}" for g, (w, p, _) in zip(geoms, first)
             if w != p]
    print(f"autotune: winners that differ from the static prior: "
          f"{'; '.join(flips) or 'none'} | off bit-identical with and "
          f"without the pack | phase {time.perf_counter() - t_phase:.1f} "
          f"s | card {smi}")
    obs.reset()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port "
              "is smoke-run on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import correlate as cr
    from veles.simd_tpu_torch.ops import batched as bt
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.runtime import breaker, faults
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils import platform as plat
    from veles.simd_tpu_torch.utils.platform import smi_line

    t_start = time.perf_counter()
    set_config(device="cuda")
    obs.enable()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    def cuda(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # 1. card: a probe subprocess first, then the first device touch
    # under a deadline
    plat.require_reachable_device(timeout=120.0)
    with plat.init_deadline(180.0, what="CUDA init"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
    smi = smi_line()
    print(f"card: {kind} | count {count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    print("probes: " + json.dumps(plat.probe_history()))

    # 2. build
    t0 = time.perf_counter()
    ck.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in ck.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    compiles = {c["name"]: c["value"] for c in obs.snapshot()["counters"]
                if c["name"].startswith("compile.")}
    check(compiles in ({"compile.cache_hits": 1},
                       {"compile.cache_misses": 1,
                        "compile.backend_compile": 1}),
          f"build: compile counters {compiles}, want one build or one "
          "cache hit")
    print(f"build: {build_s:.1f} s | compile counters {compiles} | "
          + " | ".join(ptxas))
    lib = ck.load_library()
    print("persistent kernels, blocks resident per SM: filter_bank mma "
          f"(1 x {K_FB} taps) {lib.veles_fb_mma_resident(1, K_FB)}, "
          f"filter_2d ({K_2D} x {K_2D}) {lib.veles_f2d_resident(K_2D, K_2D)}")

    # 3. parity: kernel vs plain version, same inputs on the card
    parity = {}

    # the FFT kernels (K1, K4) against their plain versions run in
    # float64: a float32 direct sum of 16384 terms drifts by about 5e-6
    # of its max on its own, half the tolerance
    def os_case(name, rows, n, k):
        x = cuda(rng.randn(rows, n) if rows > 1 else rng.randn(n))
        t = cuda(rng.randn(k))
        got = ck.overlap_save_cuda(x, t)
        want = ck.overlap_save_plain(x.double(), t.double())
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    # K2 and K5 against their plain versions run in float64 too: the
    # mma variant's split TF32 drops the lo.lo terms, and both read
    # the zero halo (pad_left=, pad=) that the plain versions F.pad
    def fb_case(name, rows, n, filt, stride, dilation, n_out, pad_left=0,
                reverse=False, variant=None):
        x = cuda(rng.randn(rows, n))
        f = cuda(filt)
        got = ck.filter_bank_cuda(x, f, stride, dilation, n_out,
                                  pad_left=pad_left, reverse_taps=reverse,
                                  variant=variant)
        want = ck.filter_bank_plain(x.double(), f.double(), stride,
                                    dilation, n_out, pad_left, reverse)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[name] = (diff, diff / scale)

    os_case("os 1048576x2047", 1, N_HEAD, K_HEAD)
    os_case("os 3x200000x2047", 3, 200000, K_HEAD)
    os_case("os 100000x2", 1, 100000, 2)
    os_case("os 100000x257", 1, 100000, 257)
    os_case("os 3x50000x256", 3, 50000, 256)
    os_case("os 3x50000x16384", 3, 50000, 16384)
    os_case("os 512x4096x300", 512, 4096, 300)      # one segment a row
    os_case("os 64x1000x300", 64, 1000, 300)        # N = 4096
    fb_case("fb C1 512x16384x129", ROWS_FB, N_FB, rng.randn(1, K_FB), 1,
            1, N_FB + K_FB - 1, K_FB - 1, True)
    # both variants at the main shape, whichever FB_MMA_MIN_K picks
    for v in ("ffma", "mma"):
        fb_case(f"fb C1 512x16384x129 {v}", ROWS_FB, N_FB,
                rng.randn(1, K_FB), 1, 1, N_FB + K_FB - 1, K_FB - 1, True, v)
    # unit stride, C = 1: the padded entry on the unpadded rows at every
    # k of the sweep's range, and an explicit x_ext
    for k in K_PARITY:
        for rows, n in ((1, 1), (8, 1663), (512, 16384)):
            if (rows, n, k) != (ROWS_FB, N_FB, K_FB):
                fb_case(f"fb C1 {rows}x{n}x{k} pad", rows, n,
                        rng.randn(1, k), 1, 1, n + k - 1, k - 1)
        fb_case(f"fb C1 8x{1663 + 2 * (k - 1)}x{k} ext", 8,
                1663 + 2 * (k - 1), rng.randn(1, k), 1, 1, 1663 + k - 1)
    for k in (3, 16, 129):      # rows beyond a grid dimension (65535)
        fb_case(f"fb C1 70000x20x{k} pad", 70000, 20, rng.randn(1, k), 1,
                1, 20 + k - 1, k - 1, True)
    for c, k in ((2, 8), (2, 40), (3, 5), (3, 100)):   # C = 2: SWT level 1
        fb_case(f"fb C{c} 64x4096x{k} ext", 64, 4096 + k - 1,
                rng.randn(c, k), 1, 1, 4096)
    daub = np.stack([DAUB8_LO[::-1] * (-1.0) ** np.arange(8), DAUB8_LO])
    fb_case("fb C2 s2 512x4096 daub8", 512, 4096 + 6, daub, 2, 1, 2048)
    fb_case("fb C2 d4 512x4096 daub8", 512, 4096 + 7 * 4, daub, 1, 4,
            4096)
    P = wv.ExtensionType.PERIODIC

    def level_loop(v):
        # the cascade one wavelet_apply a level (K2 at >= MIN_ROWS rows),
        # beside wavelet_transform's default, the fused cascade at any
        # row count
        bands = []
        for _ in range(LEVELS):
            hi_, v = wv.wavelet_apply("daub", 8, P, v)
            bands.append(hi_)
        return bands + [v]

    # K3 in both call forms against its plain versions run in float64:
    # the contract form on the periodically extended input, the
    # periodic form (wrap read in place, natural-order levels) on the
    # signal itself
    def cb_case(name, rows, n, type, order, levels):
        plans, taps, reach = wv._cascade_plan_for(
            wv.WaveletType(type), order, levels)
        ns = 1 << levels
        x = cuda(rng.randn(rows, n))
        x_ext = x[:, np.arange(n + reach + ns) % n].contiguous()
        got = ck.cascade_bank_cuda(x_ext, taps, plans, ns, n // ns)
        want = ck.cascade_bank_plain(x_ext.double(), taps, plans, ns,
                                     n // ns)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[f"{name} contract"] = (diff, diff / scale)
        got = ck.cascade_bank_periodic_cuda(x, taps, plans, levels)
        want = ck.cascade_bank_periodic_plain(x.double(), taps, plans,
                                              levels)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[f"{name} periodic"] = (diff, diff / scale)

    def f2d_case(name, imgs, n0, n1, k0, k1, padded=False):
        # padded: the direct route's call (unpadded images, the halo and
        # the flip read in the kernel); else an explicit x_ext
        p = (k0 - 1, k1 - 1) if padded else (0, 0)
        x = cuda(rng.randn(imgs, n0 + 2 * (k0 - 1 - p[0]),
                           n1 + 2 * (k1 - 1 - p[1])))
        k = cuda(rng.randn(k0, k1))
        shape = (n0 + k0 - 1, n1 + k1 - 1)
        got = ck.filter_2d_cuda(x, k, *shape, pad=p, reverse_taps=padded)
        want = ck.filter_2d_plain(x.double(), k.double(), *shape, p,
                                  padded)
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    cb_case("cb daub8 L3 512x4096", ROWS_WV, N_WV, "daub", 8, LEVELS)
    cb_case("cb daub4 L4 8x1024", 8, 1024, "daub", 4, 4)
    cb_case("cb coif12 L2 8x512", 8, 512, "coif", 12, 2)
    cb_case("cb daub8 L3 37x1000", 37, 1000, "daub", 8, 3)
    cb_case("cb sym16 L3 3x2048", 3, 2048, "sym", 16, 3)
    cb_case("cb daub2 L2 70000x4", 70000, 4, "daub", 2, 2)  # wrap > n
    # the benchmark's two DWT shapes: 2^26 samples a call in 4 rows of
    # 2^24 (per-row indices past 2^24) and in 16,384 rows of 4096
    cb_case("cb daub8 L3 4x16777216", 4, 1 << 24, "daub", 8, LEVELS)
    cb_case("cb daub8 L3 16384x4096", 16384, 4096, "daub", 8, LEVELS)
    # the contract form on a plan of its own: 3 phases, odd rows off
    # 16-byte alignment (4-byte staging), more channels than a pass
    cb_plans = tuple(tuple((int(rng.randint(3)), int(rng.randint(3)))
                           for _ in range(5)) for _ in range(6))
    cb_taps = [rng.randn(5) for _ in cb_plans]
    x_odd = cuda(rng.randn(7 * 1001 + 1))[1:].view(7, 1001)
    got = ck.cascade_bank_cuda(x_odd, cb_taps, cb_plans, 3, 331)
    want = ck.cascade_bank_plain(x_odd.double(), cb_taps, cb_plans, 3, 331)
    torch.cuda.synchronize()
    diff = max((g - w).abs().max().item() for g, w in zip(got, want))
    parity["cb 3-phase 7x1001 contract"] = (
        diff, diff / max(w.abs().max().item() for w in want))
    f2d_case("f2d 16x512x512 7x7", IMGS_2D, N_2D, N_2D, K_2D, K_2D, True)
    f2d_case("f2d 16x512x512 7x7 ext", IMGS_2D, N_2D, N_2D, K_2D, K_2D)
    f2d_case("f2d 1x128x128 3x3", 1, 128, 128, 3, 3)
    f2d_case("f2d 4x100x77 16x16", 4, 100, 77, 16, 16)
    f2d_case("f2d 3x64x300 1x256", 3, 64, 300, 1, 256)
    f2d_case("f2d 4x100x77 16x16 pad", 4, 100, 77, 16, 16, True)
    f2d_case("f2d 3x64x300 1x256 pad", 3, 64, 300, 1, 256, True)
    f2d_case("f2d 2x300x20 256x1 pad", 2, 300, 20, 256, 1, True)

    def stft_case(name, rows, n, L, hop):
        x = cuda(rng.randn(rows, n))
        w = sp.hann_window(L)
        got = torch.view_as_real(ck.stft_cuda(x, cuda(w), L, hop))
        want = torch.view_as_real(ck.stft_plain(x.double(), w, L, hop))
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    stft_case("stft 1x1048576 512/128", 1, N_ST, L_ST, HOP_ST)
    stft_case("stft 64x16384 512/128", ROWS_BS, N_BS, L_ST, HOP_ST)
    stft_case("stft 3x5000 256/128", 3, 5000, 256, 128)
    stft_case("stft 2x8192 1024/128", 2, 8192, 1024, 128)
    stft_case("stft 4x4096 384/128", 4, 4096, 384, 128)
    stft_case("stft 2x700 512/128", 2, 700, 512, 128)   # < one block
    stft_case("stft 3x2000 255/85", 3, 2000, 255, 85)   # odd: complex FFT
    stft_case("stft 2x5000 640/128", 2, 5000, 640, 128)
    stft_case("stft 2x20000 4096/128", 2, 20000, 4096, 128)
    stft_case("stft 2x40000 16384/128", 2, 40000, 16384, 128)
    # hops that do not divide the frame: the benchmark's two shapes,
    # a span of no 16-byte alignment, and a hop over half the frame
    stft_case("stft 64x1048576 400/160", 64, 1 << 20, 400, 160)
    stft_case("stft 64x1048576 2048/512", 64, 1 << 20, 2048, 512)
    stft_case("stft 2x30000 2048/441", 2, 30000, 2048, 441)
    stft_case("stft 2x5000 512/200", 2, 5000, 512, 200)
    stft_case("stft 2x5000 512/384", 2, 5000, 512, 384)
    for name, (diff, rel) in parity.items():
        check(rel <= PARITY_TOL, f"{name}: rel err {rel:.3e} > "
              f"{PARITY_TOL}")
    print("parity: " + " | ".join(f"{k} rel {v[1]:.2e}"
                                  for k, v in parity.items()))

    # 4. main path through the entry points
    launches = {}
    x_head = rng.randn(N_HEAD).astype(np.float32)
    h_head = rng.randn(K_HEAD).astype(np.float32)
    ck.reset_launches()
    handle = cv.convolve_initialize(N_HEAD, K_HEAD)
    y = cv.convolve(handle, x_head, h_head)
    torch.cuda.synchronize()
    launches["overlap_save"] = ck.LAUNCHES["overlap_save"]
    check(handle.algorithm is cv.ConvolutionAlgorithm.OVERLAP_SAVE
          and handle.os_matmul, f"headline handle is {handle}")
    check(launches["overlap_save"] >= 1,
          "convolve did not launch the overlap-save kernel")
    check(tuple(y.shape) == (N_HEAD + K_HEAD - 1,), f"shape {y.shape}")
    err_conv = rel_err(y.cpu().numpy(), fft_conv64(x_head, h_head))
    check(err_conv <= ORACLE_TOL, f"convolve rel err {err_conv:.3e}")

    pos = 300007
    x_mf = 0.1 * rng.randn(N_HEAD).astype(np.float32)
    x_mf[pos:pos + K_HEAD] += h_head
    ck.reset_launches()
    corr = cr.cross_correlate_initialize(N_HEAD, K_HEAD)
    y_mf = cr.cross_correlate(corr, x_mf, h_head)
    torch.cuda.synchronize()
    mf_launches = ck.LAUNCHES["overlap_save"]
    peak = int(torch.argmax(y_mf).item())
    check(mf_launches >= 1, "cross_correlate did not launch the kernel")
    check(peak == pos + K_HEAD - 1, f"matched-filter peak at {peak}, "
          f"want {pos + K_HEAD - 1}")

    x_fb = rng.randn(ROWS_FB, N_FB).astype(np.float32)
    h_fb = rng.randn(K_FB).astype(np.float32)
    ck.reset_launches()
    y_fb = cv.convolve_simd(x_fb, h_fb)
    torch.cuda.synchronize()
    launches["filter_bank"] = ck.LAUNCHES["filter_bank"]
    check(launches["filter_bank"] >= 1,
          "convolve_simd did not launch the filter-bank kernel")
    err_simd = rel_err(y_fb.cpu().numpy(), fft_conv64(x_fb, h_fb))
    check(err_simd <= ORACLE_TOL, f"convolve_simd rel err {err_simd:.3e}")
    routes = [e["decision"] for e in obs.events()
              if e["op"] == "convolve_os_route"]
    print(f"main: convolve {N_HEAD}x{K_HEAD} rel {err_conv:.2e} "
          f"(os launches {launches['overlap_save']}, routes {routes}) | "
          f"matched filter peak {peak} (os launches {mf_launches}) | "
          f"convolve_simd {ROWS_FB}x{N_FB}x{K_FB} rel {err_simd:.2e} "
          f"(fb launches {launches['filter_bank']})")

    # the wavelet slice: 512 x 4096 daub8 (BASELINE config 5)
    x_wv = rng.randn(ROWS_WV, N_WV).astype(np.float32)
    ck.reset_launches()
    hi, lo = wv.wavelet_apply("daub", 8, P, x_wv)
    torch.cuda.synchronize()
    launches["filter_bank_dwt"] = ck.LAUNCHES["filter_bank"]
    check(launches["filter_bank_dwt"] >= 1,
          "wavelet_apply did not launch the filter-bank kernel")
    want_hi, want_lo = wv.wavelet_apply_na("daub", 8, P, x_wv)
    err_dwt = max(rel_err(hi.cpu().numpy(), want_hi),
                  rel_err(lo.cpu().numpy(), want_lo))
    check(err_dwt <= ORACLE_TOL, f"wavelet_apply rel err {err_dwt:.3e}")

    ck.reset_launches()
    shi, slo = wv.stationary_wavelet_apply("daub", 8, 3, P, x_wv)
    torch.cuda.synchronize()
    swt_launches = ck.LAUNCHES["filter_bank"]
    check(swt_launches >= 1, "stationary_wavelet_apply did not launch "
          "the filter-bank kernel")
    want_shi, want_slo = wv.stationary_wavelet_apply_na("daub", 8, 3, P,
                                                        x_wv)
    err_swt = max(rel_err(shi.cpu().numpy(), want_shi),
                  rel_err(slo.cpu().numpy(), want_slo))
    check(err_swt <= ORACLE_TOL, f"stationary_wavelet_apply rel err "
          f"{err_swt:.3e}")

    want_c, cur = [], x_wv
    for _ in range(LEVELS):
        h_, cur = wv.wavelet_apply_na("daub", 8, P, cur)
        want_c.append(h_)
    want_c.append(cur)
    ck.reset_launches()
    loop = level_loop(x_wv)
    torch.cuda.synchronize()
    loop_launches = dict(ck.LAUNCHES)
    check(loop_launches["filter_bank"] == LEVELS
          and loop_launches["cascade_bank"] == 0,
          f"level loop launches {loop_launches}")
    err_loop = max(rel_err(g.cpu().numpy(), w)
                   for g, w in zip(loop, want_c))
    check(err_loop <= ORACLE_TOL, f"level loop rel err {err_loop:.3e}")
    ck.reset_launches()
    fused = wv.wavelet_transform("daub", 8, P, x_wv, LEVELS)
    torch.cuda.synchronize()
    fused_launches = dict(ck.LAUNCHES)
    launches["cascade_bank"] = ck.LAUNCHES["cascade_bank"]
    # the default: one launch of the periodic form and nothing else of
    # the port's
    check(launches["cascade_bank"] == 1
          and sum(fused_launches.values()) == 1,
          f"the default cascade launched {fused_launches}")
    fused_gap = max(
        float((f - g).abs().max().item())
        / max(1.0, float(g.abs().max().item()))
        for f, g in zip(fused, loop))
    check(fused_gap <= CASCADE_TOL, f"fused vs level loop {fused_gap:.3e}")
    err_fused = max(rel_err(g.cpu().numpy(), w)
                    for g, w in zip(fused, want_c))
    check(err_fused <= ORACLE_TOL, f"fused cascade rel err "
          f"{err_fused:.3e}")
    # fewer than MIN_ROWS rows (the benchmark's 4-row form, one signal
    # alone): the default is one launch of the periodic form and
    # nothing else of the port's, against the NumPy level loop
    few = {}
    for shape in ((4, 1 << 20), (1 << 16,)):
        x_few = rng.randn(*shape).astype(np.float32)
        ck.reset_launches()
        got_few = wv.wavelet_transform("daub", 8, P, x_few, LEVELS)
        torch.cuda.synchronize()
        few_launches = dict(ck.LAUNCHES)
        name = "x".join(map(str, shape))
        check(few_launches["cascade_bank"] == 1
              and sum(few_launches.values()) == 1,
              f"wavelet_transform {name} launched {few_launches}")
        want_few, cur = [], x_few
        for _ in range(LEVELS):
            h_, cur = wv.wavelet_apply_na("daub", 8, P, cur)
            want_few.append(h_)
        want_few.append(cur)
        few[name] = max(rel_err(g.cpu().numpy(), w)
                        for g, w in zip(got_few, want_few))
        check(few[name] <= ORACLE_TOL, f"wavelet_transform {name} rel "
              f"err {few[name]:.3e}")
    rec = wv.wavelet_reconstruct("daub", 8, hi, lo)
    trip = float(np.max(np.abs(rec.cpu().numpy() - x_wv)))
    check(trip <= ROUND_TRIP_TOL, f"DWT round trip {trip:.3e}")
    print(f"main: wavelet_apply {ROWS_WV}x{N_WV} daub8 rel {err_dwt:.2e} "
          f"(fb launches {launches['filter_bank_dwt']}) | "
          f"stationary_wavelet_apply level 3 rel {err_swt:.2e} "
          f"(fb launches {swt_launches}) | wavelet_transform L{LEVELS} "
          f"level loop rel {err_loop:.2e} (launches {loop_launches}) | "
          f"fused rel {err_fused:.2e}, vs loop {fused_gap:.2e} "
          f"(cb launches {launches['cascade_bank']}) | fused "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in few.items())
          + f" (one cb launch each) | round trip max abs {trip:.2e}")

    # 2D convolution: 16 x 512 x 512 with 7 x 7
    x_2d = rng.randn(IMGS_2D, N_2D, N_2D).astype(np.float32)
    h_2d = rng.randn(K_2D, K_2D).astype(np.float32)
    ck.reset_launches()
    y_2d = cv2.convolve2d(x_2d, h_2d)
    torch.cuda.synchronize()
    launches["filter_2d"] = ck.LAUNCHES["filter_2d"]
    check(launches["filter_2d"] >= 1,
          "convolve2d did not launch the 2D kernel")
    err_2d = rel_err(y_2d.cpu().numpy(), conv2d64(x_2d, h_2d))
    check(err_2d <= ORACLE_TOL, f"convolve2d rel err {err_2d:.3e}")
    ck.reset_launches()
    yc_2d = cv2.cross_correlate2d(x_2d, h_2d, mode="same")
    torch.cuda.synchronize()
    xc_launches = ck.LAUNCHES["filter_2d"]
    check(xc_launches >= 1, "cross_correlate2d did not launch the 2D "
          "kernel")
    s0 = K_2D // 2
    want_xc = conv2d64(x_2d, h_2d[::-1, ::-1])[:, s0:s0 + N_2D,
                                               s0:s0 + N_2D]
    err_xc = rel_err(yc_2d.cpu().numpy(), want_xc)
    check(err_xc <= ORACLE_TOL, f"cross_correlate2d rel err {err_xc:.3e}")
    y_fc = cv.fftconvolve(x_2d[:2], h_2d)
    err_fc = rel_err(y_fc.cpu().numpy(), conv2d64(x_2d[:2], h_2d))
    check(err_fc <= ORACLE_TOL, f"2D fftconvolve rel err {err_fc:.3e}")
    # 'same' reads the halo in the kernel; 'wrap' extends first and the
    # kernel computes only the kept part of the full output
    s1 = (K_2D - 1) // 2
    x_wrap = np.pad(x_2d, ((0, 0), (K_2D - 1,) * 2, (K_2D - 1,) * 2),
                    mode="wrap")
    mb_err, mb_launches = {}, {}
    for label, kw, want in (
            ("same", {"mode": "same"},
             lambda: conv2d64(x_2d, h_2d)[:, s1:s1 + N_2D, s1:s1 + N_2D]),
            ("wrap", {"boundary": "wrap"},
             lambda: conv2d64(x_wrap, h_2d)[
                 :, K_2D - 1:K_2D - 1 + N_2D + K_2D - 1,
                 K_2D - 1:K_2D - 1 + N_2D + K_2D - 1])):
        ck.reset_launches()
        y_mb = cv2.convolve2d(x_2d, h_2d, **kw)
        torch.cuda.synchronize()
        mb_launches[label] = ck.LAUNCHES["filter_2d"]
        check(mb_launches[label] == 1, f"convolve2d {label} launches "
              f"{mb_launches[label]}")
        mb_err[label] = rel_err(y_mb.cpu().numpy(), want())
        check(mb_err[label] <= ORACLE_TOL, f"convolve2d {label} rel err "
              f"{mb_err[label]:.3e}")
    print(f"main: convolve2d {IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D} rel "
          f"{err_2d:.2e} (f2d launches {launches['filter_2d']}) | "
          f"cross_correlate2d same rel {err_xc:.2e} (f2d launches "
          f"{xc_launches}) | fftconvolve 2D rel {err_fc:.2e} | "
          + " | ".join(f"convolve2d {k} rel {v:.2e} (f2d launches "
                       f"{mb_launches[k]})" for k, v in mb_err.items()))

    # the spectral slice: stft on 2^20 samples at 512/128
    x_st = rng.randn(N_ST).astype(np.float32)
    want_st = sp.stft_na(x_st, L_ST, HOP_ST)
    obs.reset()
    ck.reset_launches()
    y_st = sp.stft(x_st, L_ST, HOP_ST)
    torch.cuda.synchronize()
    launches["stft"] = ck.LAUNCHES["stft"]
    st_routes = [e["decision"] for e in obs.events()
                 if e["op"] == "stft_route"]
    check(st_routes == ["cuda_fused"], f"stft routes {st_routes}")
    check(launches["stft"] >= 1, "stft did not launch the STFT kernel")
    err_st = crel_err(y_st.cpu().numpy(), want_st)
    check(err_st <= ORACLE_TOL, f"stft rel err {err_st:.3e}")
    forced_err = {}
    for route in ("rdft_matmul", "xla_fft"):
        ck.reset_launches()
        y_r = sp.stft(x_st, L_ST, HOP_ST, route=route)
        torch.cuda.synchronize()
        check(ck.LAUNCHES["stft"] == 0, f"forced {route} launched K4")
        forced_err[route] = crel_err(y_r.cpu().numpy(), want_st)
        check(forced_err[route] <= ORACLE_TOL,
              f"stft {route} rel err {forced_err[route]:.3e}")
    x_bs = rng.randn(ROWS_BS, N_BS).astype(np.float32)
    want_bs = sp.stft_na(x_bs, L_ST, HOP_ST)
    ck.reset_launches()
    y_bs = bt.batched_stft(x_bs, L_ST, HOP_ST)
    torch.cuda.synchronize()
    launches["stft_batched"] = ck.LAUNCHES["stft"]
    check(launches["stft_batched"] >= 1,
          "batched_stft did not launch the STFT kernel")
    err_bs = crel_err(y_bs.cpu().numpy(), want_bs)
    check(err_bs <= ORACLE_TOL, f"batched_stft rel err {err_bs:.3e}")
    ck.reset_launches()
    y_sg = sp.spectrogram(x_bs, L_ST, HOP_ST)
    torch.cuda.synchronize()
    sg_launches = ck.LAUNCHES["stft"]
    err_sg = rel_err(y_sg.cpu().numpy(), np.abs(want_bs) ** 2)
    check(sg_launches >= 1 and err_sg <= ORACLE_TOL,
          f"spectrogram rel err {err_sg:.3e}, launches {sg_launches}")
    rec = sp.istft(sp.stft(x_bs, L_ST, HOP_ST), N_BS, L_ST, HOP_ST)
    core = slice(L_ST, N_BS - L_ST)
    trip_st = float(np.max(np.abs(rec.cpu().numpy()[:, core]
                                  - x_bs[:, core])))
    check(trip_st <= STFT_TRIP_TOL, f"istft round trip {trip_st:.3e}")
    f_w, p_w = sp.welch(x_bs, nperseg=L_ST)
    err_w = rel_err(p_w.cpu().numpy(), sp.welch_na(x_bs, nperseg=L_ST)[1])
    check(err_w <= ORACLE_TOL, f"welch rel err {err_w:.3e}")
    print(f"main: stft {N_ST} {L_ST}/{HOP_ST} routes {st_routes} rel "
          f"{err_st:.2e} (stft launches {launches['stft']}) | forced "
          + " | ".join(f"{k} rel {v:.2e}" for k, v in forced_err.items())
          + f" | batched_stft {ROWS_BS}x{N_BS} rel {err_bs:.2e} (stft "
          f"launches {launches['stft_batched']}) | spectrogram rel "
          f"{err_sg:.2e} (launches {sg_launches}) | istft round trip "
          f"interior max abs {trip_st:.2e} | welch nperseg {L_ST} rel "
          f"{err_w:.2e}")

    an_parts = []
    for rows, n, route in ((8, 1024, "matmul_dft"),
                           (4, 65536, "xla_fft")):
        x_h = rng.randn(rows, n).astype(np.float32)
        obs.reset()
        y_h = sp.hilbert(x_h)
        env = sp.envelope(x_h)
        torch.cuda.synchronize()
        h_routes = {e["decision"] for e in obs.events()
                    if e["op"] == "hilbert_route"}
        check(h_routes == {route}, f"hilbert n={n} routes {h_routes}")
        want_h = sp.hilbert_na(x_h)
        err_h = max(crel_err(y_h.cpu().numpy(), want_h),
                    rel_err(env.cpu().numpy(), np.abs(want_h)))
        check(err_h <= ORACLE_TOL, f"hilbert n={n} rel err {err_h:.3e}")
        an_parts.append(f"hilbert/envelope {rows}x{n} {route} rel "
                        f"{err_h:.2e}")
    x_cw = rng.randn(ROWS_CWT, N_CWT).astype(np.float32)
    scales = np.geomspace(2.0, 512.0, SCALES_CWT)
    obs.reset()
    y_cw = sp.morlet_cwt(x_cw, scales)
    torch.cuda.synchronize()
    cw_routes = [e["decision"] for e in obs.events()
                 if e["op"] == "morlet_cwt_route"]
    check(cw_routes == ["ct_matmul"], f"morlet_cwt routes {cw_routes}")
    err_cw = crel_err(y_cw.cpu().numpy(), sp.morlet_cwt_na(x_cw, scales))
    check(err_cw <= ORACLE_TOL, f"morlet_cwt rel err {err_cw:.3e}")
    print("main: " + " | ".join(an_parts) + f" | morlet_cwt {ROWS_CWT}x"
          f"{N_CWT} {SCALES_CWT} scales {cw_routes[0]} rel {err_cw:.2e}")

    healthy("main", obs, faults, breaker)

    # the resource axis: one main-path call per kernel, each row's work
    # held to utils.benchmark's at that shape
    n_cbs = sum(len(p_) for p_ in wv._cascade_plan_for(
        wv.WaveletType("daub"), 8, LEVELS)[0])

    def fused_cascade_call():
        wv.wavelet_transform("daub", 8, P, x_wv, LEVELS)

    resources_line(torch, obs, (
        ("overlap_save", lambda: cv.convolve(handle, x_head, h_head),
         bm.conv_work(1, N_HEAD, K_HEAD)),
        ("filter_bank", lambda: cv.convolve_simd(x_fb, h_fb),
         bm.conv_work(ROWS_FB, N_FB, K_FB)),
        ("filter_bank", lambda: wv.wavelet_apply("daub", 8, P, x_wv),
         bm.filter_bank_work(ROWS_WV, N_WV + 8, 2, 8, N_WV // 2)),
        ("cascade_bank", fused_cascade_call,
         bm.cascade_bank_work(ROWS_WV, N_WV, n_cbs, 1 << LEVELS,
                              N_WV >> LEVELS)),
        ("filter_2d", lambda: cv2.convolve2d(x_2d, h_2d),
         bm.conv2d_work(IMGS_2D, N_2D, N_2D, K_2D, K_2D)),
        ("stft", lambda: sp.stft(x_st, L_ST, HOP_ST),
         bm.stft_work(1, N_ST, L_ST, HOP_ST))))
    healthy("resources", obs, faults, breaker)
    # the other families' rows (the JAX package's instrumented cores)
    t_ops = time.perf_counter()
    ops_rows = ops_resource_rows(torch, obs, bm, dev, rng)
    ops_s = time.perf_counter() - t_ops
    check(ops_s < 15.0, f"resources ops: {ops_s:.1f} s, budget 15 s")
    print("resources ops: " + json.dumps(
        {"seconds": round(ops_s, 3), "rows": ops_rows}))
    healthy("resources ops", obs, faults, breaker)

    # 4b. the reference-header surface and the filters
    reference(torch, rng, bm, obs, ck, smi)
    healthy("reference", obs, faults, breaker)

    # 4c. the IIR and resampling families
    dsp(torch, rng, bm, ck, smi)
    healthy("dsp", obs, faults, breaker)

    # 4d. the fault policy under injected plans, then a clean engine
    faults_phase(torch, rng, bm, ck, obs, smi)
    healthy("faults (after its reset)", obs, faults, breaker)

    # 4e. the measured autotuner and its tune cache
    autotune_phase(torch, rng, obs, ck, smi)
    healthy("autotune", obs, faults, breaker)

    # 4f. the pipeline compiler: one CUDA-graph replay per block
    pipeline_phase(torch, rng, bm, obs, faults, breaker, ck, smi)
    healthy("pipeline", obs, faults, breaker)

    # 4g. the serving loop: bench config 11's mix, the K4 class, ragged
    # packing, a served pipeline, the resilience triad, the endpoint
    serve_phase(torch, np.random.RandomState(SEED), bm, obs, faults,
                breaker, ck, smi)
    healthy("serve", obs, faults, breaker)

    # 4h. the serving fleet: the replica campaign in thread and
    # subprocess mode, K4 in every replica, the scaler's ramp
    fleet_phase(torch, np.random.RandomState(SEED + 1), bm, obs, faults,
                breaker, ck, smi)

    # 4i. the sharded families on an 8-shard mesh of the one card
    parallel_phase(torch, np.random.RandomState(SEED + 2), bm, obs,
                   faults, breaker, ck, smi)
    healthy("parallel (after its reset)", obs, faults, breaker)

    # 5. times at the main-path shapes
    obs.disable()
    F = torch.nn.functional
    xh, th = cuda(x_head), cuda(h_head)
    head_ms = bm.device_time_ms(lambda: cv.convolve(handle, xh, th))

    def from_numpy():
        cv.convolve(handle, x_head, h_head)
        torch.cuda.synchronize()

    host_ms = bm.host_time(from_numpy, repeats=5) * 1e3
    print(f"headline: convolve {N_HEAD}x{K_HEAD} on the card "
          f"{head_ms:.4f} ms = {N_HEAD / head_ms / 1e3:.1f} Msamples/s | "
          f"from NumPy input, host clock {host_ms:.3f} ms")
    print("breakdown convolve (from NumPy input, device us per call): "
          + bm.device_breakdown(from_numpy, calls=5))
    # the handle's own cuFFT overlap-save route (the os_fft path) at the
    # same shape, K1's yardstick for the convolve.os route prior
    y_osf = cv._conv_overlap_save(xh, th, handle.block_length)
    err_osf = rel_err(y_osf.cpu().numpy(), fft_conv64(x_head, h_head))
    check(err_osf <= ORACLE_TOL, f"cuFFT overlap-save rel err "
          f"{err_osf:.3e}")

    def os_fft():
        return cv._conv_overlap_save(xh, th, handle.block_length)

    print(f"os_fft: convolve._conv_overlap_save {N_HEAD}x{K_HEAD} (cuFFT, "
          f"block {handle.block_length}) on the card "
          f"{bm.device_time_ms(os_fft):.4f} ms chained, device busy "
          f"{bm.device_busy_ms(os_fft):.4f} ms, rel {err_osf:.2e} | "
          "breakdown (device us per call): "
          + bm.device_breakdown(os_fft, calls=5))
    xs_t, hs_t = cuda(x_fb), cuda(h_fb)
    simd_ms = bm.device_time_ms(lambda: cv.convolve_simd(xs_t, hs_t))

    def simd_from_numpy():
        cv.convolve_simd(x_fb, h_fb)
        torch.cuda.synchronize()

    print(f"direct: convolve_simd {ROWS_FB}x{N_FB}x{K_FB} on the card "
          f"{simd_ms:.4f} ms = "
          f"{ROWS_FB * N_FB / simd_ms / 1e3:.1f} Msamples/s")
    bd_simd = bm.device_breakdown(simd_from_numpy, calls=5)
    print("breakdown convolve_simd (from NumPy input, device us per "
          "call): " + bd_simd)
    # the halo and the reversal are read in the kernel: no pad (an
    # elementwise copy and fill) and no flip (an index kernel) runs
    check("elementwise" not in bd_simd,
          f"convolve_simd runs a pad or flip kernel: {bd_simd}")

    # the wavelet slice and 2D convolution, operands on the card
    xw_t = cuda(x_wv)
    def dwt():
        return wv.wavelet_apply("daub", 8, P, xw_t)

    dwt_ms = bm.device_time_ms(dwt)
    print(f"dwt: wavelet_apply {ROWS_WV}x{N_WV} daub8 on the card "
          f"{dwt_ms:.4f} ms = {ROWS_WV * N_WV / dwt_ms / 1e3:.1f} "
          "Msamples/s (chained)")
    print("breakdown dwt (device us per call): "
          + bm.device_breakdown(dwt, calls=5))

    def cascade():
        return level_loop(xw_t)

    def fused_cascade():
        return wv.wavelet_transform("daub", 8, P, xw_t, LEVELS)

    # in turns: loop, fused, fused, loop (one card, one call); the
    # chained time (CUDA events) and the device's busy time per call
    casc = [("level_loop", cascade), ("fused", fused_cascade),
            ("fused", fused_cascade), ("level_loop", cascade)]
    casc_ms = [(name, bm.device_time_ms(fn), bm.device_busy_ms(fn))
               for name, fn in casc]
    print(f"cascade: wavelet_transform daub8 L{LEVELS} {ROWS_WV}x{N_WV} "
          "ms per call (chained / device busy), in turns: " + " | ".join(
              f"{name} {ms:.4f} = {ROWS_WV * N_WV / ms / 1e3:.1f} "
              f"Msamples/s / {busy:.4f}" for name, ms, busy in casc_ms))
    print("breakdown cascade level loop (device us per call): "
          + bm.device_breakdown(cascade, calls=5))
    bd_fused = bm.device_breakdown(fused_cascade, calls=5)
    print("breakdown cascade fused (device us per call): " + bd_fused)
    # the route's device work is the one cascade-bank launch: no
    # extension copy (cat), no interleaving stack
    fused_kernels = bm.device_kernels(fused_cascade, calls=5)
    check(fused_kernels and all("cb_frames" in k for k in fused_kernels),
          f"the fused cascade runs more than K3: {fused_kernels}")
    x2_t, h2_t = cuda(x_2d), cuda(h_2d)
    c2d_ms = bm.device_time_ms(lambda: cv2.convolve2d(x2_t, h2_t))
    print(f"conv2d: convolve2d {IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D} on "
          f"the card {c2d_ms:.4f} ms = "
          f"{IMGS_2D * N_2D * N_2D / c2d_ms / 1e3:.1f} Msamples/s")
    bd_2d = bm.device_breakdown(lambda: cv2.convolve2d(x2_t, h2_t),
                                calls=5)
    print("breakdown convolve2d (device us per call): " + bd_2d)
    check("elementwise" not in bd_2d,
          f"convolve2d runs a pad or flip kernel: {bd_2d}")

    # the spectral slice, operands on the card
    xst_t = cuda(x_st)
    xbs_t = cuda(x_bs)

    def stft_numpy():
        sp.stft(x_st, L_ST, HOP_ST)
        torch.cuda.synchronize()

    def batched_numpy():
        bt.batched_stft(x_bs, L_ST, HOP_ST)
        torch.cuda.synchronize()

    spectral_calls = [
        ("stft auto", lambda: sp.stft(xst_t, L_ST, HOP_ST), stft_numpy,
         N_ST),
        ("stft rdft_matmul",
         lambda: sp.stft(xst_t, L_ST, HOP_ST, route="rdft_matmul"), None,
         N_ST),
        ("stft xla_fft",
         lambda: sp.stft(xst_t, L_ST, HOP_ST, route="xla_fft"), None,
         N_ST),
        ("batched_stft", lambda: bt.batched_stft(xbs_t, L_ST, HOP_ST),
         batched_numpy, ROWS_BS * N_BS),
    ]
    for name, fn, from_np, samples in spectral_calls:
        chained = bm.device_time_ms(fn)
        busy = bm.device_busy_ms(fn)
        line = (f"spectral: {name} {L_ST}/{HOP_ST} on {samples} samples, "
                f"on the card {chained:.4f} ms chained = "
                f"{samples / chained / 1e3:.1f} Msamples/s, device busy "
                f"{busy:.4f} ms")
        if from_np is not None:
            line += (f" | from NumPy input, host clock "
                     f"{bm.host_time(from_np, repeats=5) * 1e3:.3f} ms")
        print(line)
        print(f"breakdown {name} (device us per call): "
              + bm.device_breakdown(fn, calls=5))

    # K2 and K5 through the direct routes' own calls: the unpadded
    # input, the halo and (for convolution) the reversed taps read in
    # the kernel
    xf = cuda(x_fb)
    ff = cuda(h_fb).reshape(1, K_FB)
    ff_flip = cuda(h_fb[::-1].copy()).view(1, 1, K_FB)
    n_out_fb = N_FB + K_FB - 1

    # the K2 variants at 512 x 16384 across k, in turns (ffma, mma, mma,
    # ffma): the data for FB_MMA_MIN_K and the convolve.direct gate
    sweep = []
    for k in K_SWEEP:
        fk = cuda(rng.randn(1, k))

        def sweep_call(v, fk=fk, k=k):
            return lambda: ck.filter_bank_cuda(
                xf, fk, 1, 1, N_FB + k - 1, pad_left=k - 1, variant=v)

        turns = [(v, bm.device_busy_ms(sweep_call(v), calls=10))
                 for v in ("ffma", "mma", "mma", "ffma")]
        bound = bm.fp32_bound(*bm.conv_work(ROWS_FB, N_FB, k))[0]
        sweep.append((k, turns, bound))
    # each variant's mean at the main shape, for the kernels line
    fb_variant_ms = {v: float(np.mean([ms for v_, ms in turns if v_ == v]))
                     for k, turns, _ in sweep if k == K_FB
                     for v in ("ffma", "mma")}
    print(f"k-sweep: K2 at {ROWS_FB}x{N_FB}, profiled ms per call in turns "
          "(picked by FB_MMA_MIN_K = " f"{ck.FB_MMA_MIN_K}): " + " | ".join(
              f"k {k} " + " ".join(f"{v} {ms:.4f}" for v, ms in turns)
              + f" bound {bound:.4f}" for k, turns, bound in sweep))
    # K2 at the DWT shape, K3 at the cascade shape, K5 at the 2D shape
    xw_ext = wv._extend(xw_t, P, 8).contiguous()
    fw = wv._filter_tensor(wv.WaveletType("daub"), 8, dev)
    n_dwt = N_WV // 2
    plans, taps, reach = wv._cascade_plan_for(
        wv.WaveletType("daub"), 8, LEVELS)
    ns = 1 << LEVELS
    n_cb = N_WV // ns
    xc_ext = wv._extend(xw_t, P, reach + ns).contiguous()
    n_slots = sum(len(plan) for plan in plans)
    max_off = max(o for plan in plans for _, o in plan)
    w_cb = np.zeros((len(plans), (max_off + 1) * ns), np.float32)
    for c, (plan, t) in enumerate(zip(plans, taps)):
        for (p_, o_), tap in zip(plan, t):
            w_cb[c, o_ * ns + p_] += tap
    w_cb_t = cuda(w_cb).unsqueeze(1)
    k2f = x2_t.new_tensor(h_2d[::-1, ::-1].copy())
    n_2d = N_2D + K_2D - 1

    def conv1d_head():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xh.view(1, 1, -1), th.flip(0).view(1, 1, -1),
                            padding=K_HEAD - 1)

    def conv1d_fb():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xf.view(ROWS_FB, 1, -1), ff_flip,
                            padding=K_FB - 1)

    def conv1d_dwt():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xw_ext.unsqueeze(1), fw.unsqueeze(1),
                            stride=2)[..., :n_dwt]

    def conv1d_cb():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xc_ext.unsqueeze(1), w_cb_t,
                            stride=ns)[..., :n_cb]

    def conv2d_2d():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(x2_t.unsqueeze(1), k2f.view(1, 1, K_2D, K_2D),
                            padding=K_2D - 1)

    win_st = cuda(sp.hann_window(L_ST))

    def torch_stft():
        return torch.stft(xst_t, L_ST, HOP_ST, window=win_st, center=False,
                          return_complex=True)

    # float64 references of the kernels' own functions
    xc64 = xc_ext.cpu().numpy().astype(np.float64)
    want_cb = np.zeros((len(plans), ROWS_WV, n_cb))
    for c, (plan, t) in enumerate(zip(plans, taps)):
        for (p_, o_), tap in zip(plan, t):
            start = o_ * ns + p_
            want_cb[c] += float(tap) * xc64[:, start:start
                                            + (n_cb - 1) * ns + 1:ns]
    lib_err = {
        "filter_bank_dwt": rel_err(
            conv1d_dwt().transpose(0, 1).cpu().numpy(),
            np.stack([want_hi, want_lo])),
        "cascade_bank": rel_err(conv1d_cb().transpose(0, 1).cpu().numpy(),
                                want_cb),
        "filter_2d": rel_err(conv2d_2d().squeeze(1).cpu().numpy(),
                             conv2d64(x_2d, h_2d)),
        "overlap_save": rel_err(conv1d_head().view(-1).cpu().numpy(),
                                fft_conv64(x_head, h_head)),
        "filter_bank": rel_err(
            conv1d_fb().view(ROWS_FB, -1).cpu().numpy(),
            fft_conv64(x_fb, h_fb)),
        "stft": crel_err(torch_stft().T.cpu().numpy(), want_st),
    }
    work = {
        "filter_bank_dwt": (2.0 * 2 * 8 * ROWS_WV * n_dwt,
                            4.0 * (xw_ext.numel() + 16
                                   + 2 * ROWS_WV * n_dwt)),
        # the unextended signal read once, its n coefficients a row
        # written once: the periodic form's own traffic
        "cascade_bank": (2.0 * n_slots * ROWS_WV * n_cb,
                         4.0 * (xw_t.numel() + n_slots + ROWS_WV * N_WV)),
        "filter_2d": bm.conv2d_work(IMGS_2D, N_2D, N_2D, K_2D, K_2D),
        "overlap_save": bm.conv_work(1, N_HEAD, K_HEAD),
        # the functions' least work (FFT form where it is less)
        "filter_bank": bm.conv_work(ROWS_FB, N_FB, K_FB),
        "stft": bm.stft_work(1, N_ST, L_ST, HOP_ST),
    }
    timed = {
        "filter_bank_dwt": (
            lambda: ck.filter_bank_cuda(xw_ext, fw, 2, 1, n_dwt),
            lambda: ck.filter_bank_plain(xw_ext, fw, 2, 1, n_dwt),
            conv1d_dwt),
        # the periodic form, as the fused route calls it
        "cascade_bank": (
            lambda: ck.cascade_bank_periodic_cuda(xw_t, taps, plans,
                                                  LEVELS),
            lambda: ck.cascade_bank_periodic_plain(xw_t, taps, plans,
                                                   LEVELS),
            conv1d_cb),
        "filter_2d": (
            lambda: ck.filter_2d_cuda(x2_t, h2_t, n_2d, n_2d,
                                      pad=(K_2D - 1,) * 2,
                                      reverse_taps=True),
            lambda: ck.filter_2d_plain(x2_t, h2_t, n_2d, n_2d,
                                       (K_2D - 1,) * 2, True),
            conv2d_2d),
        "overlap_save": (
            lambda: ck.overlap_save_cuda(xh, th),
            lambda: ck.overlap_save_plain(xh, th), conv1d_head),
        "filter_bank": (
            lambda: ck.filter_bank_cuda(xf, ff, 1, 1, n_out_fb,
                                        pad_left=K_FB - 1,
                                        reverse_taps=True),
            lambda: ck.filter_bank_plain(xf, ff, 1, 1, n_out_fb,
                                         K_FB - 1, True),
            conv1d_fb),
        "stft": (
            lambda: ck.stft_cuda(xst_t, win_st, L_ST, HOP_ST),
            lambda: ck.stft_plain(xst_t, sp.hann_window(L_ST), L_ST,
                                  HOP_ST),
            torch_stft),
    }
    meta = {
        "filter_bank_dwt": (
            "veles/simd_tpu_torch/csrc/filter_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:326",
            f"{ROWS_WV}x{N_WV} daub8 DWT", parity["fb C2 s2 512x4096 daub8"]),
        "cascade_bank": (
            "veles/simd_tpu_torch/csrc/cascade_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:387",
            f"{ROWS_WV}x{N_WV} daub8 L{LEVELS}",
            parity["cb daub8 L3 512x4096 periodic"]),
        "filter_2d": (
            "veles/simd_tpu_torch/csrc/filter_2d.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:515",
            f"{IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D}",
            parity["f2d 16x512x512 7x7"]),
        "overlap_save": (
            "veles/simd_tpu_torch/csrc/overlap_save.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:679",
            f"{N_HEAD}x{K_HEAD}", parity["os 1048576x2047"]),
        "filter_bank": (
            "veles/simd_tpu_torch/csrc/filter_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:326",
            f"{ROWS_FB}x{N_FB}x{K_FB}", parity["fb C1 512x16384x129"]),
        "stft": (
            "veles/simd_tpu_torch/csrc/stft.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:831",
            f"{N_ST} samples, {L_ST}/{HOP_ST}",
            parity["stft 1x1048576 512/128"]),
    }
    rows = []
    for name, (kern, plain, lib) in timed.items():
        # device time per call (CUPTI's records): the kernels of the
        # wavelet and 2D shapes are shorter than their wrappers' host
        # dispatch, so chained CUDA events would time the host
        ms = bm.device_busy_ms(kern, calls=20)
        chained_ms = bm.device_time_ms(kern, iters=50)
        plain_ms = bm.device_busy_ms(plain, calls=3)
        lib_ms = bm.device_busy_ms(lib, calls=20)
        bound_ms, bound_by = bm.fp32_bound(*work[name])
        # no call of the same function beats its bound: a time under it
        # is a profiled window that lost device time
        check(ms >= bound_ms and lib_ms >= bound_ms,
              f"kernels {name}: {ms:.5f} ms, library {lib_ms:.5f} ms, "
              f"under the bound {bound_ms:.5f} ms")
        source, replaces, shape, (diff, rel) = meta[name]
        variant = {"filter_bank": ck.fb_variant(K_FB, 1, 1),
                   "filter_bank_dwt": ck.fb_variant(8, 2, 1)}.get(name)
        rows.append({
            "name": name.replace("_dwt", ""), "route": "cuda",
            "source": source,
            "replaces": replaces, "shape": shape,
            "launches": launches[name], "max_abs_err": diff,
            "max_rel_err": rel, "ms": ms, "chained_ms": chained_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_rel_err_vs_f64": lib_err[name],
        })
        if variant is not None:
            rows[-1]["variant"] = variant
        if name == "filter_bank":
            # both variants at this shape (k-sweep, profiled, in turns)
            rows[-1]["variant_ms"] = fb_variant_ms
        if name == "cascade_bank":
            # the contract form on the extended input, as the parity
            # and the library yardstick read it
            rows[-1]["form"] = "periodic"
            rows[-1]["contract_ms"] = bm.device_busy_ms(
                lambda: ck.cascade_bank_cuda(xc_ext, taps, plans, ns, n_cb),
                calls=20)
    n_breakers = healthy("times", obs, faults, breaker)

    # 6. the C ABI: csrc's C suite against the port, the C entries; and
    # 7. the artifact store: the warm pack in a fresh process, a stale
    # one.  After the measurements, so that `times` reads the card
    # before any C bridge or child process of these phases has run
    cabi_phase(np.random.RandomState(SEED + 3), bm, ck, smi, kind)
    artifacts_phase(ck, smi, build_s, compiles)
    n_breakers = healthy("cabi and artifacts", obs, faults, breaker)
    # 8. bench_torch.py's configs 4-6 and the port's smoke
    bench_phase(obs, faults, breaker, smi)
    n_breakers = healthy("bench", obs, faults, breaker)
    # 9. the suite: tools/benchmark_suite_torch.py's rows on the card
    suite_phase(obs, faults, breaker, smi)
    n_breakers = healthy("suite", obs, faults, breaker)
    # 9b. the examples and 9c. the tuning and profiling tools
    examples_phase(torch, ck, obs, faults, breaker, smi)
    tools_phase(torch, ck, obs, faults, breaker, smi)
    n_breakers = healthy("examples and tools", obs, faults, breaker)
    # 9d. the flagship step and its training step (graft_entry_torch.py)
    train_phase(torch, ck, bm, obs, faults, breaker, smi)
    n_breakers = healthy("train", obs, faults, breaker)
    # 9e. the developer gate: lint, the table generator, K2 on its rows
    devtools_phase(torch, ck, obs, faults, breaker, smi)
    n_breakers = healthy("devtools", obs, faults, breaker)
    # 10. the chaos campaigns (fault plans, so healthy after its reset)
    chaos_phase(obs, faults, breaker, smi,
                time.perf_counter() - t_start)
    healthy("chaos (after its reset)", obs, faults, breaker)
    print("healthy: main, reference, dsp, autotune, times, cabi, "
          "artifacts, bench, suite, examples, tools, train and devtools "
          "recorded "
          "no fault_* counter, no fault_policy event and no fault "
          f"record; {n_breakers} breakers, all closed and never failed")
    elapsed = time.perf_counter() - t_start
    print(f"times: card {smi} | chip_smoke {elapsed:.1f} s so far")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
