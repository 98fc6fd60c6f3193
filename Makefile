# Top-level driver — parity with the reference's autotools targets
# (/root/reference/Makefile.am:30-43): `make tests` runs every suite with
# a timeout + peak-RSS + log + failure gate, `make benchmarks` prints the
# relative-speedup lines, `make cshim` builds the native C ABI.

PYTHON ?= python

.PHONY: all tests tests-quick benchmarks bench bench-regress \
        bench-multichip bench-serve bench-goodput bench-rpc \
        serve-smoke \
        chaos-smoke chaos-replicas chaos-replicas-rpc chaos-scale \
        cshim cshim-check \
        wavelet-tables \
        lint docs obs-report obs-dash obs-query autotune-pack \
        warm-pack \
        cold-start install install-hooks clean

all: cshim

tests:
	$(PYTHON) tools/run_tests.py

# inner-loop signal in ~3 min: everything except the @pytest.mark.slow
# suites (sharded-mesh sweeps, multi-process gates, examples, the C
# suite).  The full gate (`make tests`) stays the CI/judging bar.
tests-quick:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) -m pytest tests/ -q -m "not slow"

benchmarks:
	$(PYTHON) tools/benchmark_suite.py

bench:
	$(PYTHON) bench.py --all

# fold the latest bench run into BENCH_HISTORY.jsonl and fail (rc=1) on
# a headline/suite regression vs the trailing-median baseline — the CI
# gate after `make bench`.  Knobs: tools/bench_regress.py --help
bench-regress:
	$(PYTHON) tools/bench_regress.py

# the MULTICHIP bench family: pod-scale Fourier rows (sharded_rfft
# matmul-DFT vs local FFT, sharded_stft above the matmul cutoff) on a
# device mesh, written to MULTICHIP_DETAILS.json with per-route
# roofline % and per-stage all_to_all ICI bytes.  Gate with
# `python tools/bench_regress.py --details MULTICHIP_DETAILS.json`.
bench-multichip:
	$(PYTHON) tools/bench_multichip.py

# the SERVE bench family: loadgen traffic (Poisson + bursts, mixed
# tenants/shapes) through the serving layer, written to
# SERVE_DETAILS.json (throughput + inverse-p99 rows; rc=1 on any
# lost/double-answered request).  Gate with
# `python tools/bench_regress.py --details SERVE_DETAILS.json`.
bench-serve:
	$(PYTHON) tools/loadgen.py --details SERVE_DETAILS.json

# the GOODPUT bench family: the saturation A/B campaign — one
# heavy-tailed mixed-shape schedule served flat-out with continuous
# batching + ragged packing OFF (the padding-waste baseline) then ON,
# written to GOODPUT_DETAILS.json (sample goodput, waste-recovery
# multiple, inverse-p99; rc=1 unless the measured padding waste
# recovers >= 2x with p99 held).  Gate with
# `python tools/bench_regress.py --details GOODPUT_DETAILS.json`.
bench-goodput:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) tools/loadgen.py --saturation \
		--details GOODPUT_DETAILS.json
	$(PYTHON) tools/bench_regress.py --details GOODPUT_DETAILS.json

# the RPC bench family: identical loadgen traffic through an
# in-process 2-replica group vs a spawn="subprocess" group over the
# RPC data plane (serve/rpc.py), written to RPC_DETAILS.json
# (subprocess/thread throughput ratio + inverse added-p50 rows; rc=1
# if the wire adds more than the p50 budget or any request fails).
# Gate with `python tools/bench_regress.py --details RPC_DETAILS.json`.
bench-rpc:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) tools/loadgen.py --rpc-overhead \
		--details RPC_DETAILS.json
	$(PYTHON) tools/bench_regress.py --details RPC_DETAILS.json

# seconds-long CPU sanity run of the serving layer (accounting +
# oracle parity gate, including pipeline-invocation streams with
# state threading); the chaos variant arms VELES_SIMD_FAULT_PLAN
serve-smoke:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) tools/loadgen.py --smoke

# the scripted chaos campaign on CPU: overload -> poisoned served
# PIPELINE class (its breaker opens while plain ops stay ok) ->
# mid-campaign device loss (one poisoned serve class + the sharded
# mesh) -> recovery, gating on zero lost / zero double-answered
# requests, typed errors only, bounded deadline misses, breaker
# open->half-open->closed (serve, pipeline, and mesh breakers), and
# mesh_degrade + recovery (tools/chaos.py; CHAOS_DETAILS.json rows
# gate via `python tools/bench_regress.py --details CHAOS_DETAILS.json`)
chaos-smoke:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos.py --smoke

# the REPLICATED chaos campaign on CPU: 3 in-process server replicas
# behind the breaker-aware front router — one replica killed abruptly
# (no drain) mid-traffic with its queued work failing over onto
# survivors (original deadlines carried), then another drained
# gracefully — gating zero lost / zero double-answered requests across
# the GROUP, terminal traces on the killed replica's requests,
# survivor absorption, and a live router-level /healthz throughout
# (tools/chaos.py --replicas; REPLICA_DETAILS.json rows gate via
# `python tools/bench_regress.py --details REPLICA_DETAILS.json`)
chaos-replicas:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos.py --replicas --smoke

# the same replicated campaign over the RPC DATA PLANE: three child
# processes behind the front router (serve/rpc.py pooled connections),
# the abrupt kill a real SIGKILL mid-traffic — zero lost / zero
# double-answered, failover deadlines carried, and the lifecycle
# reconstructable from the journal pack must all hold across the wire
# (tools/chaos.py --replicas --spawn subprocess; spawn-suffixed rows in
# REPLICA_RPC_DETAILS.json gate via `python tools/bench_regress.py
# --details REPLICA_RPC_DETAILS.json`)
chaos-replicas-rpc:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos.py --replicas --spawn subprocess --smoke

# the CONTROL-AXIS chaos campaign on CPU (obs v7): a ~10x diurnal
# traffic ramp over a scaler-armed ReplicaGroup — the SLO-driven
# autoscaler must spawn under the peak's queue backlog, retire back to
# min through the sustained-idle window, keep p99 + SLO hit rate in
# budget, hold replica-seconds within a factor of the oracle schedule,
# produce ZERO actions under a synthetic flap-storm, and leave a
# journal pack from which the whole incident -> action -> effect chain
# reconstructs offline (tools/chaos.py --scale; SCALE_DETAILS.json
# rows gate via `python tools/bench_regress.py --details
# SCALE_DETAILS.json`)
chaos-scale:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos.py --scale --smoke

cshim:
	$(MAKE) -C csrc all

cshim-check:
	$(MAKE) -C csrc check

wavelet-tables:
	$(PYTHON) tools/gen_wavelet_tables.py

lint:
	$(PYTHON) tools/lint.py

docs:
	$(PYTHON) tools/gen_docs.py

# pretty-print a saved telemetry snapshot (obs.save(...) output or a
# bench.py BENCH_DETAILS.json); override with SNAPSHOT=path
SNAPSHOT ?= BENCH_DETAILS.json
obs-report:
	$(PYTHON) tools/obs_report.py $(SNAPSHOT)

# live dashboard against a serving process's scrape endpoint
# (obs/http.py, armed via VELES_SIMD_OBS_PORT or Server(obs_port=...));
# override with OBS_PORT=9100 or pass --url via tools/obs_dash.py
obs-dash:
	$(PYTHON) tools/obs_dash.py $(if $(OBS_PORT),--port $(OBS_PORT),)

# offline postmortem queries over a durable journal pack (obs v6,
# written by any process running with $VELES_SIMD_JOURNAL_DIR set):
# merged fleet timeline, per-rid/replica/site/time filters, incident
# postmortems, Chrome-trace export.  Override with
# JOURNAL=path/to/pack and QUERY='--postmortem all' etc.
JOURNAL ?= journal_pack
obs-query:
	$(PYTHON) tools/obs_query.py $(JOURNAL) $(QUERY)

# build the pre-warmed autotune pack: measure every routed family's
# candidates on THIS device and persist the winners so production
# processes (VELES_SIMD_AUTOTUNE=readonly + _AUTOTUNE_CACHE=pack)
# never pay route exploration.  Override with PACK=path.
PACK ?= autotune_pack.json
autotune-pack:
	$(PYTHON) tools/autotune_pack.py --out $(PACK)

# build the pre-warmed AOT ARTIFACT pack: export every serving shape
# class's compiled executable (jax.export, stamped + sha256'd) plus
# the persistent-XLA-cache leg into one directory a fresh process
# preloads at serve.Server.start — zero-warmup cold start
# (VELES_SIMD_ARTIFACTS=readonly + VELES_SIMD_ARTIFACT_DIR=pack).
# Override with WARM_PACK=path.
WARM_PACK ?= warm_pack
warm-pack:
	$(PYTHON) tools/warm_pack.py --dir $(WARM_PACK)

# the cold-start bench family: process-birth -> first-request wall
# clock of a fresh subprocess server, warm pack vs cold, written to
# COLD_START_DETAILS.json with artifact hit/stale/miss evidence.
# Gate with `python tools/bench_regress.py --details
# COLD_START_DETAILS.json`.
cold-start:
	$(PYTHON) tools/cold_start.py

# Installs the commit gate: `make tests-quick` must be green before any
# code commit (round-4 postmortem: snapshot 8182983 landed red at HEAD).
install-hooks:
	install -m 755 tools/git-hooks/pre-commit "$$(git rev-parse --git-path hooks)/pre-commit"
	@echo "pre-commit quick-gate hook installed"

# pip-installs the Python/XLA core, then the C ABI (PREFIX=/usr/local).
# --no-build-isolation: build with the environment's setuptools so the
# install works air-gapped (pip's isolated build env needs network).
install:
	$(PYTHON) -m pip install --no-build-isolation .
	$(MAKE) -C csrc install

clean:
	$(MAKE) -C csrc clean
	rm -f tests.log test_results_*.xml COLD_START_DETAILS.json
	rm -rf warm_pack

# --- the PyTorch/CUDA port (veles/simd_tpu_torch/) -------------------------
# The -torch twin of each target above that drives a JAX tool: the same
# flags and environment, the port's tool (tools/*_torch.py,
# bench_torch.py).  The port computes on the CUDA card unless
# VELES_SIMD_PLATFORM=cpu.  No twin: bench-regress (the JAX bench's
# history gate; the port's benchmark has none yet), cshim (csrc's own
# build: the port builds its C library at first use,
# veles/simd_tpu_torch/cabi), install and install-hooks (one package,
# one hook).  cabi-check-torch is cshim-check's twin (the C suite
# against the port; CABI_PLATFORM=cpu runs it on the CPU), chip-smoke
# the port's proof run on the card.

.PHONY: tests-torch tests-quick-torch benchmarks-torch bench-torch \
        bench-multichip-torch bench-serve-torch bench-goodput-torch \
        bench-rpc-torch serve-smoke-torch \
        chaos-smoke-torch chaos-replicas-torch chaos-replicas-rpc-torch \
        chaos-scale-torch cabi-check-torch wavelet-tables-torch \
        lint-torch docs-torch obs-report-torch obs-dash-torch \
        obs-query-torch autotune-pack-torch warm-pack-torch \
        cold-start-torch chip-smoke

tests-torch:
	$(PYTHON) tools/run_tests_torch.py

tests-quick-torch:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) -m pytest tests/test_torch_*.py -q \
		-m "not slow"

benchmarks-torch:
	$(PYTHON) tools/benchmark_suite_torch.py

bench-torch:
	$(PYTHON) bench_torch.py --all

bench-multichip-torch:
	$(PYTHON) tools/bench_multichip_torch.py

bench-serve-torch:
	$(PYTHON) tools/loadgen_torch.py --details SERVE_DETAILS_torch.json

bench-goodput-torch:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) tools/loadgen_torch.py --saturation \
		--details GOODPUT_DETAILS_torch.json

bench-rpc-torch:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) tools/loadgen_torch.py \
		--rpc-overhead --details RPC_DETAILS_torch.json

serve-smoke-torch:
	VELES_SIMD_PLATFORM=cpu $(PYTHON) tools/loadgen_torch.py --smoke

chaos-smoke-torch:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos_torch.py --smoke

chaos-replicas-torch:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos_torch.py --replicas --smoke

chaos-replicas-rpc-torch:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos_torch.py --replicas --spawn subprocess --smoke

chaos-scale-torch:
	VELES_SIMD_PLATFORM=cpu VELES_SIMD_FAULT_BACKOFF=0 \
		$(PYTHON) tools/chaos_torch.py --scale --smoke

CABI_PLATFORM ?=
cabi-check-torch:
	$(PYTHON) -c "import subprocess, sys; \
	from veles.simd_tpu_torch import cabi; \
	prog = cabi.build_program('csrc/test_veles_simd.c'); \
	env = cabi.program_env('$(CABI_PLATFORM)' or None); \
	sys.exit(subprocess.run([str(prog)], env=env).returncode)"

wavelet-tables-torch:
	$(PYTHON) tools/gen_wavelet_tables_torch.py

lint-torch:
	$(PYTHON) tools/lint_torch.py

docs-torch:
	$(PYTHON) tools/gen_docs_torch.py

SNAPSHOT_TORCH ?= BENCH_DETAILS_torch.json
obs-report-torch:
	$(PYTHON) tools/obs_report_torch.py $(SNAPSHOT_TORCH)

obs-dash-torch:
	$(PYTHON) tools/obs_dash_torch.py $(if $(OBS_PORT),--port $(OBS_PORT),)

obs-query-torch:
	$(PYTHON) tools/obs_query_torch.py $(JOURNAL) $(QUERY)

PACK_TORCH ?= autotune_pack_torch.json
autotune-pack-torch:
	$(PYTHON) tools/autotune_pack_torch.py --out $(PACK_TORCH)

WARM_PACK_TORCH ?= warm_pack_torch
warm-pack-torch:
	$(PYTHON) tools/warm_pack_torch.py --dir $(WARM_PACK_TORCH)

cold-start-torch:
	$(PYTHON) tools/cold_start_torch.py

chip-smoke:
	$(PYTHON) chip_smoke.py
