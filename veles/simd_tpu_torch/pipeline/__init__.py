"""veles.simd_tpu_torch.pipeline — op chains run as one step per block.

The port of ``veles.simd_tpu.pipeline``:

* **declare** a chain from stage descriptors
  (:mod:`~veles.simd_tpu_torch.pipeline.stages`):
  ``Pipeline([resample_poly(2, 1), sosfilt(sos), stft(256, 64),
  power()])``;
* **compile** it (:mod:`~veles.simd_tpu_torch.pipeline.compiler`) into
  ONE block step — every stage's carried state (IIR ``zi``, FIR halo,
  STFT frame overlap, resampler history) threaded explicitly through
  it, stage kernels resolved through the ``routing.family`` tables and
  stage constants put on the device at compile time — captured as one
  CUDA graph per batch shape on the card and replayed once per block;
* **dispatch** each block under ``faults.breaker_guarded`` at
  ``pipeline.dispatch`` with a per-pipeline-class breaker, a host
  block degrading to the stage-by-stage NumPy oracle twin;
* **ship** it: :func:`pipeline_from_spec` rebuilds a compiled chain
  from a pure-JSON spec (``{"name", "block", "stages": [{"stage":
  "sosfilt", "sos": [...]}, ...]}``); the same spec builds the same
  chain in both packages.
"""

import numpy as _np

from veles.simd_tpu_torch.pipeline.compiler import (PIPELINE_SITE,
                                                    CompiledPipeline,
                                                    Pipeline)
from veles.simd_tpu_torch.pipeline.stages import (Stage, correlate,
                                                  detect_peaks, detrend,
                                                  fir, matched_filter,
                                                  medfilt, power,
                                                  power_db,
                                                  resample_poly, savgol,
                                                  sosfilt, stft, welch)

__all__ = [
    "Pipeline", "CompiledPipeline", "PIPELINE_SITE", "Stage",
    "fir", "correlate", "matched_filter", "sosfilt", "resample_poly",
    "medfilt", "detrend", "stft", "power", "power_db", "welch",
    "savgol", "detect_peaks", "pipeline_from_spec", "SPEC_FACTORIES",
]

# the declarative surface: spec {"stage": <key>} resolves through this
# table, so a spec can only name the public stage factories
SPEC_FACTORIES = {
    "fir": fir, "correlate": correlate,
    "matched_filter": matched_filter, "sosfilt": sosfilt,
    "resample_poly": resample_poly, "medfilt": medfilt,
    "detrend": detrend, "stft": stft, "power": power,
    "power_db": power_db, "welch": welch, "savgol": savgol,
    "detect_peaks": detect_peaks,
}


def pipeline_from_spec(spec: dict) -> CompiledPipeline:
    """Compile a chain from a pure-JSON declarative spec.

    ``spec`` is ``{"name": str, "block": int, "stages": [{"stage":
    factory_key, **kwargs}, ...]}`` where ``factory_key`` names an
    entry of :data:`SPEC_FACTORIES` and the remaining keys are that
    factory's keyword arguments (list-valued kwargs — filter taps,
    SOS rows, windows — become float64 arrays).  This is the form a
    pipeline crosses a process (or package) boundary in: the same spec
    builds the same chain (``describe()`` equal) in the JAX package
    and in the port.  Malformed specs raise ``ValueError`` (typed,
    never a half-built chain)."""
    if not isinstance(spec, dict):
        raise ValueError(f"pipeline spec must be a dict, got "
                         f"{type(spec).__name__}")
    name = spec.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError("pipeline spec needs a non-empty 'name'")
    try:
        block = int(spec.get("block"))
    except (TypeError, ValueError):
        raise ValueError(f"pipeline spec {name!r} needs an integer "
                         f"'block'") from None
    raw_stages = spec.get("stages")
    if not isinstance(raw_stages, (list, tuple)) or not raw_stages:
        raise ValueError(f"pipeline spec {name!r} needs a non-empty "
                         f"'stages' list")
    stages = []
    for i, entry in enumerate(raw_stages):
        if not isinstance(entry, dict) or "stage" not in entry:
            raise ValueError(f"pipeline spec {name!r} stage #{i} must "
                             f"be a dict with a 'stage' key")
        key = entry["stage"]
        factory = SPEC_FACTORIES.get(key)
        if factory is None:
            raise ValueError(
                f"pipeline spec {name!r} stage #{i}: unknown stage "
                f"{key!r} (known: {sorted(SPEC_FACTORIES)})")
        kwargs = {k: (_np.asarray(v, dtype=_np.float64)
                      if isinstance(v, (list, tuple)) else v)
                  for k, v in entry.items() if k != "stage"}
        try:
            stages.append(factory(**kwargs))
        except (TypeError, ValueError) as e:
            raise ValueError(f"pipeline spec {name!r} stage #{i} "
                             f"({key}): {e}") from e
    return Pipeline(stages, name=name).compile(block)
