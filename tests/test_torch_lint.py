"""``tools/lint_torch.py``: the project rules over the port.

The real tree passes both passes; every rule body flags a synthetic
bad source (the import-alias forms included, as
``tests/test_lint_rules.py`` covers them for the JAX package) and
passes a good one; and each of the 23 findings the rules made on the
port before its repair stays repaired, one case each.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch as lt  # noqa: E402

P = "veles.simd_tpu_torch"
OPS = "veles/simd_tpu_torch/ops/demo.py"
SERVE = "veles/simd_tpu_torch/serve/demo.py"
PIPE = "veles/simd_tpu_torch/pipeline/demo.py"


def _errors(rule, src, fname=OPS):
    return getattr(lt, rule)(ast.parse(src), fname)


# ---------------------------------------------------------------------------
# synthetic sources: (rule, file, source, substring of the expected error
# or None for a clean source)
# ---------------------------------------------------------------------------

CASES = {
    # -- telemetry and clocks -----------------------------------------------
    "telemetry_good": ("telemetry_errors", OPS, f'''
from {P} import obs
obs.count("a")
obs.record_decision("op", "x")
obs.compile_event("/veles/cuda/library_cache_hits")
with obs.compile_timer("/veles/cuda/nvcc_build_duration") as t:
    pass
''', None),
    "telemetry_unapproved_helper": ("telemetry_errors", OPS, f'''
from {P} import obs
obs.gauge("g", 1)
''', "not an approved"),
    "telemetry_obs_alias": ("telemetry_errors", OPS, f'''
from {P} import obs as o
o.snapshot()
''', "not an approved"),
    "telemetry_internals_from": ("telemetry_errors", OPS, f'''
from {P}.obs import compile as c
c.record_event("x")
''', "internals"),
    "telemetry_internals_import": ("telemetry_errors", OPS, f'''
import {P}.obs.spans
''', "import telemetry via"),
    "clock_raw": ("telemetry_errors", OPS, '''
import time
t0 = time.perf_counter()
''', "raw time.perf_counter"),
    "clock_alias": ("telemetry_errors", OPS, '''
import time as _t
t0 = _t.monotonic()
''', "raw _t.monotonic"),
    "clock_from_import": ("telemetry_errors", OPS, '''
from time import perf_counter as pc
t0 = pc()
''', "importing perf_counter"),
    "clock_sleep_allowed": ("telemetry_errors", OPS, '''
import time
time.sleep(0)
''', None),
    # -- compile sites ------------------------------------------------------
    "compile_torch_compile": ("compile_site_errors", OPS, '''
import torch
f = torch.compile(lambda x: x)
''', "torch.compile outside"),
    "compile_torch_alias": ("compile_site_errors", OPS, '''
import torch as t
f = t.compile(lambda x: x)
''', "torch.compile outside"),
    "compile_from_import": ("compile_site_errors", OPS, '''
from torch import compile as tc
f = tc(lambda x: x)
''', "torch.compile outside"),
    "compile_jit_script": ("compile_site_errors", OPS, '''
import torch
f = torch.jit.script(lambda x: x)
''', "torch.jit.script outside"),
    "compile_jit_module_alias": ("compile_site_errors", OPS, '''
import torch.jit as tj
f = tj.trace(None, ())
''', "torch.jit.trace outside"),
    "compile_jit_from": ("compile_site_errors", OPS, '''
from torch import jit
f = jit.script(None)
''', "torch.jit.script outside"),
    "compile_graph_capture": ("compile_site_errors", OPS, '''
import torch
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    pass
''', "torch.cuda.CUDAGraph outside"),
    "compile_graph_from_import": ("compile_site_errors", OPS, '''
from torch.cuda import graph as capture
with capture(None):
    pass
''', "torch.cuda.graph outside"),
    "compile_graphed_callables": ("compile_site_errors", OPS, '''
import torch
f = torch.cuda.make_graphed_callables(None, ())
''', "make_graphed_callables outside"),
    "compile_home_may_capture": (
        "compile_site_errors", "veles/simd_tpu_torch/pipeline/compiler.py",
        '''
import torch
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    pass
''', None),
    "compile_is_compiling_is_no_compile": ("compile_site_errors", OPS, '''
import torch
busy = torch.compiler.is_compiling()
''', None),
    "cdll_outside_loaders": ("compile_site_errors", OPS, '''
import ctypes
lib = ctypes.CDLL("libx.so")
''', "ctypes.CDLL(...) outside"),
    "cdll_from_import_alias": ("compile_site_errors", OPS, '''
from ctypes import CDLL as L
lib = L("libx.so")
''', "ctypes.CDLL(...) outside"),
    "cdll_loadlibrary_alias": ("compile_site_errors", OPS, '''
import ctypes as c
lib = c.cdll.LoadLibrary("libx.so")
''', "ctypes.cdll.LoadLibrary(...) outside"),
    "cdll_annotation_is_no_call": ("compile_site_errors", OPS, '''
import ctypes
def load() -> ctypes.CDLL:
    return None
''', None),
    "cdll_in_load_library": (
        "compile_site_errors", "veles/simd_tpu_torch/ops/cuda_kernels.py",
        '''
import ctypes
def load_library():
    return ctypes.CDLL("lib.so")
''', None),
    "cdll_elsewhere_in_cuda_kernels": (
        "compile_site_errors", "veles/simd_tpu_torch/ops/cuda_kernels.py",
        '''
import ctypes
def other():
    return ctypes.CDLL("lib.so")
''', "ctypes.CDLL(...) outside"),
    "cdll_in_cabi": (
        "compile_site_errors", "veles/simd_tpu_torch/cabi/__init__.py",
        '''
import ctypes
lib = ctypes.CDLL("lib.so")
''', None),
    "cdll_in_devtrace": (
        "compile_site_errors", "veles/simd_tpu_torch/utils/devtrace.py",
        '''
import ctypes
lib = ctypes.CDLL(None)
''', None),
    # -- fault handler ------------------------------------------------------
    "fault_kernel_except": ("fault_handler_errors", OPS, f'''
from {P}.ops import cuda_kernels as _ck
def run(x):
    try:
        return _ck.stft_cuda(x, None, 512, 128)
    except Exception:
        return None
''', "raw 'except Exception'"),
    "fault_module_alias": ("fault_handler_errors", OPS, f'''
import {P}.ops.cuda_kernels as kk
def run(x):
    try:
        return kk.filter_2d_cuda(x)
    except BaseException:
        return None
''', "raw 'except Exception'"),
    "fault_instrumented_call": ("fault_handler_errors", OPS, f'''
import functools
from {P} import obs
@functools.partial(obs.instrumented_jit, op="a", route="b")
def _core(x):
    return x
def run(x):
    try:
        return _core(x)
    except Exception:
        return None
''', "raw 'except Exception'"),
    "fault_bare_except": ("fault_handler_errors", OPS, f'''
from {P}.ops import cuda_kernels as _ck
def run(x):
    try:
        return _ck.overlap_save_cuda(x)
    except:
        return None
''', "raw 'except Exception'"),
    "fault_narrow_handler": ("fault_handler_errors", OPS, f'''
from {P}.ops import cuda_kernels as _ck
def run(x):
    try:
        return _ck.overlap_save_cuda(x)
    except ValueError:
        return None
''', None),
    "fault_non_compile_site": ("fault_handler_errors", OPS, '''
def run(x):
    try:
        return int(x)
    except Exception:
        return None
''', None),
    # -- precision ----------------------------------------------------------
    "precision_layer_usage": ("precision_errors", OPS, f'''
from {P}.runtime import precision as prx
def mm(a, b):
    with prx.fp32_matmul():
        return prx.p_matmul(a, b, precision="highest")
''', None),
    "precision_set_matmul": ("precision_errors", OPS, '''
import torch
torch.set_float32_matmul_precision("high")
''', "torch.set_float32_matmul_precision"),
    "precision_from_import": ("precision_errors", OPS, '''
from torch import set_float32_matmul_precision as smp
smp("high")
''', "torch.set_float32_matmul_precision"),
    "precision_allow_tf32": ("precision_errors", OPS, '''
import torch
torch.backends.cuda.matmul.allow_tf32 = True
''', "torch.backends.cuda.matmul.allow_tf32"),
    "precision_cuda_backend_alias": ("precision_errors", OPS, '''
from torch.backends import cuda as bc
bc.matmul.allow_tf32 = True
''', "torch.backends.cuda.matmul.allow_tf32"),
    "precision_reduced_reduction": ("precision_errors", OPS, '''
import torch as t
t.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
''', "allow_bf16_reduced_precision_reduction"),
    "precision_cudnn_tf32": ("precision_errors", OPS, '''
import torch.backends.cudnn as cd
cd.allow_tf32 = False
''', "torch.backends.cudnn.allow_tf32"),
    "precision_cudnn_flags": ("precision_errors", OPS, '''
import torch
with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
    pass
''', "torch.backends.cudnn.flags"),
    "precision_cudnn_alias_flags": ("precision_errors", SERVE, '''
from torch.backends import cudnn as c
with c.flags(enabled=True):
    pass
''', "torch.backends.cudnn.flags"),
    "precision_home": (
        "precision_errors", "veles/simd_tpu_torch/runtime/precision.py",
        '''
import torch
torch.set_float32_matmul_precision("high")
''', None),
    "precision_kernels_exempt": (
        "precision_errors", "veles/simd_tpu_torch/ops/cuda_kernels.py",
        '''
import torch
torch.backends.cuda.matmul.allow_tf32 = False
''', None),
    # -- artifacts ----------------------------------------------------------
    "artifact_clean": ("artifact_serialization_errors", OPS, '''
import numpy as np
def save(buf, a):
    np.save(buf, a, allow_pickle=False)
''', None),
    "artifact_torch_save": ("artifact_serialization_errors", OPS, '''
import torch
torch.save({}, "x.pt")
''', "raw torch.save"),
    "artifact_torch_load_alias": ("artifact_serialization_errors", PIPE, '''
import torch as t
state = t.load("x.pt")
''', "raw torch.load"),
    "artifact_from_torch": ("artifact_serialization_errors", SERVE, '''
from torch import save
save({}, "x.pt")
''', "raw torch.save"),
    "artifact_pickle_alias": ("artifact_serialization_errors", OPS, '''
import pickle as pk
blob = pk.dumps({})
obj = pk.loads(blob)
''', "raw pickle.dumps"),
    "artifact_pickle_from": ("artifact_serialization_errors", OPS, '''
from pickle import load as ld
obj = ld(open("x", "rb"))
''', "raw pickle.load"),
    # -- routing selectors --------------------------------------------------
    "routing_table_backed": ("routing_selector_errors", OPS, f'''
from {P}.runtime import routing
_FAM = routing.family("demo", ())
_DEMO_ROUTES = {{}}
def _use_fast(n):
    return _FAM.static_select(n=n) == "fast"
def select_demo(n):
    return _FAM.static_select(n=n)
''', None),
    "routing_module_alias": ("routing_selector_errors", OPS, f'''
import {P}.runtime.routing as rt
_FAM = rt.family("demo", ())
def _use_fast(n):
    return _FAM.select(n=n) == "fast"
''', None),
    "routing_select_with_mode_field": ("routing_selector_errors", OPS, f'''
from {P} import obs
from {P}.runtime import routing
_FAM = routing.family("demo", ())
def select_demo(n, route=None):
    chosen = _FAM.select(route=route, n=n, tune_geom=lambda: {{"n": n}})
    obs.record_decision("demo", chosen, mode=routing.autotune_mode())
    return chosen
''', None),
    "routing_autotune_shortcut": ("routing_selector_errors", OPS, f'''
from {P}.runtime import routing
_FAM = routing.family("demo", ())
def _dispatch(n):
    if routing.autotune_mode() == "off":
        return _FAM.static_select(n=n)
    return _FAM.select(n=n)
''', "branches on routing.autotune_mode()"),
    "routing_autotune_shortcut_alias": ("routing_selector_errors", OPS,
                                        f'''
import {P}.runtime.routing as rt
_FAM = rt.family("demo", ())
def _dispatch(n):
    return (_FAM.static_select(n=n) if rt.autotune_mode() != "on"
            else _FAM.select(n=n))
''', "branches on routing.autotune_mode()"),
    "routing_hand_gate": ("routing_selector_errors", OPS, f'''
from {P}.runtime import routing
_FAM = routing.family("demo", ())
def _dispatch(n):
    fast = _FAM.route_allowed("fast", n=n)
    return _FAM.select(eligible=["fast", "slow"] if fast else ["slow"], n=n)
''', "calls Family.route_allowed"),
    "routing_family_fn_import": ("routing_selector_errors", OPS, f'''
from {P}.runtime.routing import family
_FAM = family("demo", ())
def _select_route(n):
    return _FAM.static_select(n=n)
''', None),
    "routing_hand_rolled_use": ("routing_selector_errors", OPS, '''
def _use_fast(n):
    return n < 1024
''', "selector _use_fast does not consult"),
    "routing_hand_rolled_select": ("routing_selector_errors", OPS, '''
def select_algorithm2d(k0, k1):
    return "direct" if k0 * k1 <= 256 else "fft"
''', "selector select_algorithm2d does not consult"),
    "routing_routes_without_family": ("routing_selector_errors", OPS, '''
_DEMO_ROUTES = {}
''', "without a routing.family"),
    "routing_decoy_import": ("routing_selector_errors", OPS, f'''
from {P}.runtime.routing import tune_key_str
def _use_fast(n):
    return tune_key_str(n) == "a"
''', "does not consult"),
    "routing_module_alias_decoy": ("routing_selector_errors", OPS, f'''
from {P}.runtime import routing
def _use_fast(n):
    return routing.pow2_bucket(n) < 1024
''', "does not consult"),
    # -- route dispatch -----------------------------------------------------
    "dispatch_good": ("spectral_dispatch_errors", OPS, f'''
import functools
from {P} import obs
from {P}.ops import cuda_kernels as _ck
@functools.partial(obs.instrumented_jit, op="stft", route="xla_fft")
def _core(x):
    return x
def _run_xla(x):
    return _core(x)
def _run_cuda(x):
    return _ck.stft_cuda(x, None, 512, 128)
_STFT_ROUTES = {{"xla_fft": _run_xla, "cuda_fused": _run_cuda}}
def stft(x, route):
    with obs.span("stft.dispatch", route=route):
        return _STFT_ROUTES[route](x)
''', None),
    "dispatch_kernel_module_alias": ("spectral_dispatch_errors", OPS, f'''
import {P}.ops.cuda_kernels as kk
from {P} import obs
def _run_cuda(x):
    return kk.stft_cuda(x, None, 512, 128)
_STFT_ROUTES = {{"cuda_fused": _run_cuda}}
def stft(x, route):
    with obs.span("stft.dispatch"):
        return _STFT_ROUTES[route](x)
''', None),
    "dispatch_uninstrumented_runner": ("spectral_dispatch_errors", OPS, f'''
from {P} import obs
def _run_raw(x):
    return x + 1
_STFT_ROUTES = {{"raw": _run_raw}}
def stft(x, route):
    with obs.span("stft.dispatch"):
        return _STFT_ROUTES[route](x)
''', "reaches no obs.instrumented_jit core"),
    "dispatch_partial_entry": ("spectral_dispatch_errors", OPS, f'''
import functools
from {P} import obs
@obs.instrumented_jit
def _core(x, precision):
    return x
def _run(x, precision="highest"):
    return _core(x, precision)
_STFT_ROUTES = {{"a": _run, "b": functools.partial(_run, precision="x")}}
def stft(x, route):
    with obs.span("stft.dispatch"):
        return _STFT_ROUTES[route](x)
''', "values must be module-level route runner functions"),
    "dispatch_unspanned": ("spectral_dispatch_errors", OPS, f'''
from {P} import obs
@obs.instrumented_jit(op="stft", route="xla_fft")
def _core(x):
    return x
def _run(x):
    return _core(x)
_STFT_ROUTES = {{"xla_fft": _run}}
def stft(x, route):
    return _STFT_ROUTES[route](x)
''', "outside a 'with obs.span(...)'"),
    "dispatch_closure_outside_span": ("spectral_dispatch_errors", OPS, f'''
from {P} import obs
@obs.instrumented_jit
def _core(x):
    return x
def _run(x):
    return _core(x)
_ISTFT_ROUTES = {{"xla_fft": _run}}
def istft(x, route):
    def run():
        return _ISTFT_ROUTES[route](x)
    with obs.span("istft.dispatch"):
        return run()
''', "istft dispatches _ISTFT_ROUTES outside"),
    "dispatch_closure_inside_span": ("spectral_dispatch_errors", OPS, f'''
from {P} import obs
@obs.instrumented_jit
def _core(x):
    return x
def _run(x):
    return _core(x)
_ISTFT_ROUTES = {{"xla_fft": _run}}
def istft(x, route):
    with obs.span("istft.dispatch"):
        def run():
            return _ISTFT_ROUTES[route](x)
        return run()
''', None),
    "dispatch_no_tables": ("spectral_dispatch_errors", OPS, '''
def stft(x):
    return x
''', "no *_ROUTES dispatch tables"),
    # -- serve layer --------------------------------------------------------
    "serve_guarded": ("serve_layer_errors", SERVE, f'''
from {P} import obs
from {P}.ops import batched
from {P}.runtime import faults
def dispatch(x):
    obs.count("serve_batches")
    return faults.guarded("serve.dispatch", lambda: batched.batched_stft(x))
''', None),
    "serve_bare_dispatch": ("serve_layer_errors", SERVE, f'''
from {P} import obs
from {P}.ops import batched
def dispatch(x):
    obs.count("serve_batches")
    return batched.batched_sosfilt(None, x)
''', "bare batched-op dispatch"),
    "serve_raw_time": ("serve_layer_errors", SERVE, '''
import time
''', "raw time import"),
    "serve_unobserved": ("serve_layer_errors", SERVE, f'''
from {P}.ops import batched
from {P}.runtime import faults
def dispatch(x):
    return faults.guarded("s", lambda: batched.batched_stft(x))
''', "never records via obs"),
    "serve_aliases": ("serve_layer_errors", SERVE, f'''
from {P} import obs as o
from {P}.ops.batched import batched_stft as bs
from {P}.runtime.faults import guarded as g
def dispatch(x):
    o.count("a")
    g("s", lambda: bs(x))
    return bs(x)
''', "bare batched-op dispatch"),
    "serve_oracle_exempt": ("serve_layer_errors", SERVE, f'''
from {P} import obs
from {P}.ops import batched
def dispatch(x):
    obs.count("a")
    batched.batched_stft(x, simd=False)
    return batched.batched_sosfilt_na(None, x)
''', None),
    "serve_dotted_package_dodge": ("serve_layer_errors", SERVE, f'''
import {P}.ops
from {P} import obs
def dispatch(x):
    obs.count("a")
    return veles.simd_tpu_torch.ops.batched.batched_stft(x)
''', "bare batched-op dispatch"),
    # -- request trace ------------------------------------------------------
    "trace_terminal_count": ("request_trace_errors", SERVE, f'''
from {P} import obs
obs.count("serve_completed", op="stft")
''', "hand-rolled terminal request accounting"),
    "trace_terminal_observe_alias": ("request_trace_errors", PIPE, f'''
from {P} import obs as o
o.observe("serve.request_latency", 1.0)
''', "hand-rolled terminal request accounting"),
    "trace_nonterminal": ("request_trace_errors", SERVE, f'''
from {P} import obs
obs.count("serve_batches")
tr = obs.request_trace("stft")
''', None),
    # -- cluster router -----------------------------------------------------
    "cluster_funnelled": ("cluster_router_errors", SERVE, '''
class Router:
    def _submit_to_replica(self, replica, request):
        return replica.server.submit(request)
''', None),
    "cluster_submit_outside": ("cluster_router_errors", SERVE, '''
class Router:
    def _submit_to_replica(self, replica, request):
        return replica.server.submit(request)
    def _shortcut(self, replica, request):
        return replica.server.submit(request)
''', "outside the _submit_to_replica funnel"),
    # -- rpc transport ------------------------------------------------------
    "rpc_get_scrape": ("rpc_transport_errors", SERVE, '''
import urllib.request
body = urllib.request.urlopen("http://localhost:1/metrics").read()
''', None),
    "rpc_http_import": ("rpc_transport_errors", SERVE, '''
import http.client as hc
''', "raw transport import"),
    "rpc_urlopen_body": ("rpc_transport_errors", SERVE, '''
from urllib.request import urlopen as uo
uo("http://localhost:1/submit", b"x")
''', "body-carrying urllib submission"),
    "rpc_request_post": ("rpc_transport_errors", SERVE, '''
from urllib import request as rq
rq.Request("http://localhost:1/submit", method="POST")
''', "body-carrying urllib submission"),
    # -- scaler control -----------------------------------------------------
    "scaler_contract": ("scaler_control_errors", SERVE, f'''
from {P} import obs
class Engine:
    def tick(self):
        s = obs.signals()
        obs.record_decision("scaler", "hold")
        self.group.spawn_replica()
''', None),
    "scaler_scrape_import": ("scaler_control_errors", SERVE, '''
import urllib.request
''', "scrape machinery import"),
    "scaler_parse": ("scaler_control_errors", SERVE, '''
class Engine:
    def tick(self, exp, text):
        return exp.parse_prometheus(text)
''', "scrape parsing"),
    "scaler_server_access": ("scaler_control_errors", SERVE, '''
class Engine:
    def tick(self, r):
        return r.server
''', "direct Server access"),
    "scaler_side_door": ("scaler_control_errors", SERVE, f'''
from {P} import obs as o
class Engine:
    def tick(self):
        return o.snapshot()
''', "obs read outside the control-axis surface"),
    "scaler_unapproved_verb": ("scaler_control_errors", SERVE, '''
class Engine:
    def tick(self):
        self.group.reconfigure()
''', "unapproved group call"),
    # -- fleet funnel -------------------------------------------------------
    "fleet_funnelled": ("fleet_funnel_errors", SERVE, f'''
from {P}.obs import export as obs_export
class Group:
    def _collect_fleet_sample(self, text):
        return obs_export.parse_prometheus(text)
''', None),
    "fleet_scrape_outside": ("fleet_funnel_errors", SERVE, f'''
from {P}.obs import export as obs_export
def peek(text):
    return obs_export.parse_prometheus(text)
''', "outside the _collect_fleet_sample funnel"),
    "fleet_store_read": ("fleet_funnel_errors", SERVE, f'''
from {P} import obs
def peek():
    return obs.fleet_series()
''', "outside the _collect_fleet_sample funnel"),
    "fleet_parse_alias": ("fleet_funnel_errors", SERVE, f'''
from {P}.obs.export import parse_prometheus as pp
def peek(text):
    return pp(text)
''', "outside the _collect_fleet_sample funnel"),
    # -- journal funnel -----------------------------------------------------
    "journal_funnelled": ("journal_funnel_errors", SERVE, f'''
from {P} import obs
obs.record_decision("op", "x")
''', None),
    "journal_env_open": ("journal_funnel_errors", SERVE, '''
import os
d = os.environ["VELES_SIMD_JOURNAL_DIR"]
f = open(os.path.join(d, "x"), "a")
''', "raw open() on a journal path"),
    "journal_alias_taint": ("journal_funnel_errors", SERVE, f'''
from {P}.obs import journal as jn
d = jn.journal_dir()
p = d + "/seg"
f = open(p, "a")
''', "raw open() on a journal path"),
    "journal_writer_mint": ("journal_funnel_errors", SERVE, f'''
from {P}.obs.journal import JournalWriter as W
w = W("/tmp/x")
''', "JournalWriter minted"),
    "journal_literal_path": ("journal_funnel_errors", SERVE, '''
f = open("journal-0001.jsonl", "a")
''', "raw open() on a journal path"),
    # -- parallel guard -----------------------------------------------------
    "parallel_wrapper": ("parallel_guard_errors", OPS, f'''
from {P} import obs
from {P}.runtime import faults
def _instrumented(op, fn):
    return obs.instrumented_jit(fn, op=op)
def _sharded_guard(thunk):
    return faults.guarded("parallel.x", thunk)
def run(x):
    return _sharded_guard(lambda: _instrumented("a", abs)(x))
''', None),
    "parallel_breaker_guarded": ("parallel_guard_errors", OPS, f'''
from {P} import obs
from {P}.runtime import faults
def _instrumented(op, fn):
    return obs.instrumented_jit(fn, op=op)
def run(x):
    return faults.breaker_guarded("p", (), lambda: _instrumented("a",
                                                                 abs)(x))
''', None),
    "parallel_bare_dispatch": ("parallel_guard_errors", OPS, f'''
from {P} import obs
def _instrumented(op, fn):
    return obs.instrumented_jit(fn, op=op)
def run(x):
    return _instrumented("a", abs)(x)
''', "sharded dispatch outside a faults.guarded thunk"),
    "parallel_bound_handle": ("parallel_guard_errors", OPS, f'''
from {P} import obs
def _instrumented(op, fn):
    return obs.instrumented_jit(fn, op=op)
def run(x):
    jfn = _instrumented("a", abs)
    return jfn(x)
''', "sharded dispatch outside a faults.guarded thunk"),
    "parallel_direct_instrumented": ("parallel_guard_errors", OPS, f'''
from {P} import obs
def run(x):
    return obs.instrumented_jit(abs, op="a")(x)
''', "sharded dispatch outside a faults.guarded thunk"),
    # -- segment dispatch ---------------------------------------------------
    "segments_good": ("segment_dispatch_errors", OPS, f'''
from {P}.runtime import faults, routing
_SEG = routing.family("segments", ())
def _select_packing(op):
    return _SEG.static_select(op=op)
def packed_stft(xs):
    route = _select_packing("stft")
    return faults.breaker_guarded("segments.dispatch", (route,),
                                  lambda: xs)
''', None),
    "segments_unguarded": ("segment_dispatch_errors", OPS, f'''
from {P}.runtime import routing
_SEG = routing.family("segments", ())
def packed_stft(xs):
    return _SEG.static_select(op="stft"), xs
''', "does not dispatch through faults.breaker_guarded"),
    "segments_plain_guarded": ("segment_dispatch_errors", OPS, f'''
from {P}.runtime import faults, routing
_SEG = routing.family("segments", ())
def packed_stft(xs):
    _SEG.static_select(op="stft")
    return faults.guarded("segments.dispatch", lambda: xs)
''', "does not dispatch through faults.breaker_guarded"),
    "segments_hand_rolled": ("segment_dispatch_errors", OPS, f'''
from {P}.runtime import faults
def packed_stft(xs, hop):
    gap = 0 if hop % 128 == 0 else 64
    return faults.breaker_guarded("s", (), lambda: (xs, gap))
''', "does not consult the segments routing-family table"),
    # -- pipeline -----------------------------------------------------------
    "pipeline_route_ops_hook": ("pipeline_route_errors", PIPE, f'''
from {P}.ops import spectral as sp
class _Stage:
    def resolve(self, geom):
        return sp.select_stft_stream_route(512, 128, 8)
''', None),
    "pipeline_route_trivial": ("pipeline_route_errors", PIPE, '''
class _Stage:
    def resolve(self, geom):
        """Single-kernel stage."""
        return None
''', None),
    "pipeline_route_ladder": ("pipeline_route_errors", PIPE, '''
class _Stage:
    def resolve(self, geom):
        return "rdft_matmul" if self.frame <= 4096 else "xla_fft"
''', "picks a kernel without consulting the routing engine"),
    "pipeline_guarded_step": ("pipeline_guard_errors", PIPE, f'''
from {P} import obs
from {P}.runtime import faults
class Compiled:
    def __init__(self):
        self._step = obs.instrumented_jit(self._fused, op="pipeline")
    def _fused(self, x):
        g = _GraphStep(x)
        return g.run(x)
    def _run_fused(self, x):
        return self._step(x)
    def process(self, x):
        return faults.breaker_guarded("pipeline.dispatch", (),
                                      lambda: self._run_fused(x))
class _GraphStep:
    def __init__(self, x):
        self.graph = None
    def run(self, x):
        self.graph.replay()
        return x
''', None),
    "pipeline_bare_step": ("pipeline_guard_errors", PIPE, f'''
from {P} import obs
class Compiled:
    def __init__(self):
        self._step = obs.instrumented_jit(self._fused, op="pipeline")
    def _fused(self, x):
        return x
    def process(self, x):
        return self._step(x)
''', "compiled pipeline step outside"),
    "pipeline_bare_graph_capture": ("pipeline_guard_errors", PIPE, '''
class Compiled:
    def warm(self, x):
        return _GraphStep(x)
''', "graph-step capture outside"),
    "pipeline_bare_graph_run": ("pipeline_guard_errors", PIPE, '''
class Compiled:
    def replay_last(self, x):
        g = self._graphs.get(1) or _GraphStep(x)
        return g.run(x)
''', "graph-step replay outside"),
    "pipeline_bare_replay": ("pipeline_guard_errors", PIPE, '''
class Compiled:
    def replay(self):
        self.graph.replay()
''', "CUDA-graph replay outside"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_on_synthetic_source(case):
    rule, fname, src, want = CASES[case]
    errors = _errors(rule, src, fname)
    if want is None:
        assert errors == [], errors
    else:
        assert any(want in e for e in errors), errors


def test_every_rule_has_a_flagging_and_a_clean_case():
    rules = {r for r, _f, _s, _w in CASES.values()}
    for rule in rules:
        kinds = {w is None for r, _f, _s, w in CASES.values() if r == rule}
        assert kinds == {True, False}, rule
    assert {n for n in dir(lt) if n.endswith("_errors")
            and n not in ("base_errors", "module_errors",
                          "project_errors")} <= rules


# ---------------------------------------------------------------------------
# the dispatch: which rules each layer takes, and the base pass
# ---------------------------------------------------------------------------

def test_layers_take_their_rules():
    timed = "import time\nt = time.perf_counter()\n"
    tree = ast.parse(timed)
    # compute modules: the clock rule; serve: the serve rule's time
    # import; runtime/ and obs/: neither
    assert any("raw time.perf_counter" in e for e in lt.module_errors(
        tree, "veles/simd_tpu_torch/ops/x.py"))
    assert any("raw time.perf_counter" in e for e in lt.module_errors(
        tree, "veles/simd_tpu_torch/pipeline/x.py"))
    assert any("raw time import" in e for e in lt.module_errors(
        tree, "veles/simd_tpu_torch/serve/x.py"))
    assert lt.module_errors(tree, "veles/simd_tpu_torch/runtime/x.py") == []
    assert lt.module_errors(tree, "veles/simd_tpu_torch/obs/x.py") == []
    # the package-wide rules reach every layer
    tf32 = ast.parse("import torch\ntorch.backends.cudnn.allow_tf32 = 1\n")
    for layer in ("obs", "utils", "runtime", "serve", "parallel"):
        assert lt.module_errors(tf32, f"veles/simd_tpu_torch/{layer}/x.py")


def test_base_pass_flags_each_fault(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nx = 1 \n" + "y = " + "1" * 80 + "\n")
    errors = lt.base_errors(bad)
    assert any("unused import 'os'" in e for e in errors)
    assert any("trailing whitespace" in e for e in errors)
    assert any("line too long" in e for e in errors)
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert any("compile error" in e for e in lt.base_errors(broken))
    good = tmp_path / "good.py"
    good.write_text('import os\n__all__ = ["os"]\n')
    assert lt.base_errors(good) == []


def test_the_sources_cover_the_port():
    files = {lt._rel(f) for f in lt.python_sources()}
    for name in ("veles/simd_tpu_torch/ops/spectral.py",
                 "tests/test_torch_lint.py", "tools/lint_torch.py",
                 "tools/time_torch_guard.py", "chip_smoke.py",
                 "bench_torch.py", "graft_entry_torch.py",
                 "examples/matched_filter_torch.py"):
        assert name in files, name
    assert not any(f.startswith("veles/simd_tpu/") for f in files)


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

def test_real_tree_passes_both_passes():
    assert lt.lint() == []


@pytest.mark.parametrize("layer", ["ops", "parallel", "pipeline", "serve",
                                   "runtime", "obs", "utils", "cabi"])
def test_real_layer_passes_the_project_rules(layer):
    files = sorted((REPO / "veles" / "simd_tpu_torch" / layer).rglob("*.py"))
    assert files
    assert lt.project_errors(files) == []


def test_cli_exit_status(tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint_torch.py"),
         str(REPO / "tools" / "lint_torch.py")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout
    assert "1 files, 0 errors" in out.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n")
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint_torch.py"), str(bad)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "unused import" in out.stdout


# ---------------------------------------------------------------------------
# the 23 findings of the rules on the port before its repair, one case
# each: (where it was, the rule, what it named, the repair's mark)
# ---------------------------------------------------------------------------

SP = "veles/simd_tpu_torch/ops/spectral.py"
CK = "veles/simd_tpu_torch/ops/cuda_kernels.py"
PC = "veles/simd_tpu_torch/pipeline/compiler.py"
CV2 = "veles/simd_tpu_torch/ops/convolve2d.py"
FINDINGS = [
    (f"{SP}:678", "spectral_dispatch_errors", "_run_stft_xla ", SP,
     '@functools.partial(obs.instrumented_jit, op="stft", route="xla_fft"'),
    (f"{SP}:683", "spectral_dispatch_errors", "_run_stft_rdft ", SP,
     'route="rdft_matmul", work=_stft_work)'),
    (f"{SP}:690", "spectral_dispatch_errors", "_run_stft_cuda ", SP,
     "lambda: _ck.stft_cuda("),
    (f"{SP}:721", "spectral_dispatch_errors", "_STFT_ROUTES values", SP,
     '"rdft_matmul_bf16_comp": _run_stft_rdft_comp,'),
    (f"{SP}:936", "spectral_dispatch_errors", "_run_istft_xla ", SP,
     '@functools.partial(obs.instrumented_jit, op="istft", route="xla_fft"'),
    (f"{SP}:942", "spectral_dispatch_errors", "_run_istft_rdft ", SP,
     'route="rdft_matmul", work=_istft_work)'),
    (f"{SP}:953", "spectral_dispatch_errors", "_ISTFT_ROUTES values", SP,
     '"rdft_matmul_bf16_comp": _run_istft_rdft_comp}'),
    (f"{SP}:1026", "spectral_dispatch_errors", "istft dispatches", SP,
     'with obs.span("istft.dispatch", route=chosen, path=path):\n'
     '        def run():'),
    (f"{SP}:1107", "spectral_dispatch_errors", "_run_hilbert_matmul ", SP,
     'route="matmul_dft", work=_hilbert_work)'),
    (f"{SP}:1116", "spectral_dispatch_errors", "_run_hilbert_xla ", SP,
     '@functools.partial(obs.instrumented_jit, op="hilbert", '
     'route="xla_fft"'),
    (f"{SP}:1124", "spectral_dispatch_errors", "_HILBERT_ROUTES values",
     SP, '"matmul_dft_bf16_comp": _run_hilbert_matmul_comp,'),
    (f"{SP}:1233", "spectral_dispatch_errors", "_run_cwt_matmul ", SP,
     'route="matmul_dft", work=_cwt_matmul_work)'),
    (f"{SP}:1251", "spectral_dispatch_errors", "_run_cwt_xla ", SP,
     'route="xla_fft", work=_cwt_work)'),
    (f"{SP}:1257", "spectral_dispatch_errors", "_run_cwt_ct ", SP,
     'route="ct_matmul",'),
    (f"{SP}:1268", "spectral_dispatch_errors", "_CWT_ROUTES values", SP,
     '"matmul_dft_bf16_comp": _run_cwt_matmul_comp,'),
    (f"{CV2}:114", "routing_selector_errors", "select_algorithm2d", CV2,
     'return _CONV2D_FAMILY.static_select('),
    (f"{CK}:92", "telemetry_errors", "telemetry internals", CK,
     'obs.compile_event("/veles/cuda/library_cache_misses")'),
    (f"{CK}:565", "telemetry_errors", "perf_counter", CK,
     'with obs.compile_timer("/veles/cuda/nvcc_build_duration"):'),
    (f"{CK}:568", "telemetry_errors", "raw time.", CK,
     "path = _build(out_dir)"),
    (f"{PC}:73", "telemetry_errors", "telemetry internals", PC,
     "with obs.compile_timer("),
    (f"{PC}:312", "telemetry_errors", "perf_counter", PC,
     '"/veles/pipeline/graph_capture_duration"'),
    (f"{PC}:316", "telemetry_errors", "raw time.", PC,
     ") as capture:"),
    (f"{PC}:320", "telemetry_errors", "time.perf_counter() - t0", PC,
     "seconds=round(capture.seconds, 6))"),
]


def test_the_findings_are_23():
    assert len(FINDINGS) == 23
    assert len({f[0] for f in FINDINGS}) == 23


@pytest.mark.parametrize("where,rule,named,path,repair", FINDINGS,
                         ids=[f[0].split("/")[-1] for f in FINDINGS])
def test_finding_stays_repaired(where, rule, named, path, repair):
    text = (REPO / path).read_text()
    assert repair in text
    errors = getattr(lt, rule)(ast.parse(text), path)
    assert not any(named in e for e in errors), errors
    # and the rule still sees the fault where it is put back
    assert _reintroduced(where, rule, text, path)


def _reintroduced(where, rule, text, path):
    """The rule flags the file with the fault put back (a sketch of the
    pre-repair form, appended or substituted)."""
    if rule == "spectral_dispatch_errors":
        bad = text + (
            "\n\ndef _run_plain(x, *a):\n    return x\n\n\n"
            "_PLAIN_ROUTES = {'a': _run_plain, 'b': functools.partial("
            "_run_plain)}\n\n\ndef plain(x):\n"
            "    def run():\n        return _PLAIN_ROUTES['a'](x)\n"
            "    with obs.span('plain'):\n        return run()\n")
        errors = lt.spectral_dispatch_errors(ast.parse(bad), path)
        return (any("_run_plain reaches no" in e for e in errors)
                and any("_PLAIN_ROUTES values" in e for e in errors)
                and any("plain dispatches" in e for e in errors))
    if rule == "routing_selector_errors":
        bad = text + ("\n\ndef select_plain(k0, k1):\n"
                      "    return _use_cuda_direct2d((1, 1), k0, k1, 0)\n")
        return any("select_plain" in e
                   for e in lt.routing_selector_errors(ast.parse(bad), path))
    bad = ("import time\nfrom veles.simd_tpu_torch.obs import compile "
           "as _compile\n" + text + "\n\nt0 = time.perf_counter()\n")
    errors = lt.telemetry_errors(ast.parse(bad), path)
    return (any("telemetry internals" in e for e in errors)
            and any("perf_counter" in e for e in errors))
