"""Pipeline stage descriptors: declarative links of an op chain.

The port of ``veles.simd_tpu.pipeline.stages``.  A :class:`Stage`
describes ONE link of a streaming op chain — what it computes per
fixed-size block, what state it carries between blocks, and how its
kernel is chosen — in a form the pipeline compiler
(:mod:`veles.simd_tpu_torch.pipeline.compiler`) runs as one step per
block:

* ``plan(block_in, mode)`` validates the stage's geometry against the
  incoming block length and chain mode and returns the outgoing
  ``(block_out, mode)`` — called once at compile time;
* ``resolve(tune_stamp)`` picks the stage's kernel through the
  ``routing.family`` candidate tables (``convolve`` for the FIR link,
  ``stft`` for the spectral link), with the tune class stamped
  :func:`veles.simd_tpu_torch.runtime.routing.pipeline_tune_geom`;
* ``init_state(batch_shape)`` builds the stage's zero-seeded carried
  state (NumPy float32: IIR ``zi``, FIR halo, STFT frame overlap,
  resampler history);
* ``apply(x, state)`` is the per-block step ``(x, state) -> (y,
  state')`` on tensors of the configured device; ``apply_na(x,
  state)`` its NumPy float64 twin (the degradation path);
* ``oracle(x, block_in, mode)`` is the ONE-SHOT whole-signal NumPy
  reference of the stage's STREAMING semantics.

Every constant a stage's ``apply`` reads — FIR taps, the IIR scan's
powers, the resampler's polyphase weights, windows and DFT bases, the
detrend projector, the Savitzky–Golay taps, the Welch scale — is put on
the device ONCE, by the compiler (:meth:`Stage.place`), and held by the
stage.  ``apply`` then copies nothing from the host, branches on no
tensor value and synchronises nothing, so the compiler can capture the
whole chain as one CUDA graph and replay it per block; the stage's own
references keep those constants alive for as long as the graph reads
them.

Chain **modes** thread through ``plan``: ``"samples"`` (a continuous
sample stream — per-block outputs concatenate on the last axis),
``"frames"`` (an STFT stream — outputs concatenate on the frames
axis), ``"rows"`` (one row per block — outputs stack on a new block
axis).  Stages that need sample continuity (fir/sosfilt/resample/
medfilt/stft/welch) demand ``"samples"``; per-row operators (savgol,
power, detect_peaks) accept any mode and inherit it.

Stages with LOOKAHEAD (the centered resampler, the centered median) and
the STFT's zero-seeded frame overlap emit a few pre-roll samples before
the first "interior" output — each stage reports that as ``latency``
and its ``oracle`` reproduces it exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch.ops import convolve as _cv
from veles.simd_tpu_torch.ops import detect_peaks as _dp
from veles.simd_tpu_torch.ops import filters as _fl
from veles.simd_tpu_torch.ops import iir as _iir
from veles.simd_tpu_torch.ops import resample as _rs
from veles.simd_tpu_torch.ops import spectral as _sp
from veles.simd_tpu_torch.runtime import precision as _prx
from veles.simd_tpu_torch.runtime import routing
from veles.simd_tpu_torch.utils.platform import to_host

__all__ = [
    "Stage", "fir", "correlate", "matched_filter", "sosfilt",
    "resample_poly", "medfilt", "detrend", "stft", "power",
    "power_db", "welch", "savgol", "detect_peaks", "MODES",
]

MODES = ("samples", "frames", "rows")


def _const(a, dev) -> torch.Tensor:
    """A float32 host constant as a tensor on ``dev`` (copied once)."""
    return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                           device=dev)


def _host64(a) -> np.ndarray:
    """``a`` (NumPy or a tensor on any device) as float64 NumPy."""
    return np.asarray(to_host(a), np.float64)


class Stage:
    """One chain link.  Subclasses fill in the hooks; factory functions
    (:func:`fir`, :func:`sosfilt`, ...) are the public spelling.
    ``family`` names the ``routing.family`` table the stage resolves
    through (None = single-kernel stage); ``route`` holds the resolved
    kernel after :meth:`resolve`."""

    family: str | None = None
    terminal = False

    def __init__(self, name: str):
        self.name = str(name)
        self.route: str | None = None
        self.latency = 0
        self._block_in: int | None = None

    # -- compile-time hooks -------------------------------------------------

    def plan(self, block_in: int, mode: str) -> tuple:
        """Validate geometry; return ``(block_out, mode_out)``."""
        raise NotImplementedError

    def resolve(self, tune_stamp) -> str | None:
        """Pick the kernel through the stage's routing family (called
        once at compile time; ``tune_stamp(geom)`` stamps the tune
        class as pipeline-compiled).  Default: single-kernel stage."""
        return None

    def place(self, dev) -> None:
        """Put every constant :meth:`apply` reads on ``dev`` (called
        once, by the compiler, after :meth:`resolve`).  Default: the
        stage reads none."""

    def init_state(self, batch_shape: tuple):
        """Zero-seeded carried state (NumPy), or ``()`` if stateless."""
        return ()

    # -- runtime hooks ------------------------------------------------------

    def apply(self, x, state):
        """``(x, state) -> (y, state')`` on device tensors."""
        raise NotImplementedError

    def apply_na(self, x, state):
        """NumPy float64 twin of :meth:`apply`."""
        raise NotImplementedError

    def oracle(self, x, block_in: int, mode: str):
        """One-shot whole-signal NumPy reference of the STREAMING
        semantics (pre-roll included)."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {"stage": self.name, "family": self.family,
                "route": self.route, "latency": self.latency}


def _require_mode(stage, mode: str, want: str = "samples") -> None:
    if mode != want:
        raise ValueError(
            f"stage {stage.name!r} needs a {want!r}-mode input, got "
            f"{mode!r} (it cannot follow a frame/row-producing stage)")


def _detrend_consts(n: int, dev):
    """The linear detrend's ``[2, n]`` pseudo-inverse and ``[n, 2]``
    Vandermonde on ``dev`` (``spectral.detrend``'s closed form)."""
    a = np.c_[np.arange(n, dtype=np.float64), np.ones(n)]
    return _const(np.linalg.pinv(a), dev), _const(a, dev)


def _detrend_t(x, type, consts):  # noqa: A002
    """``spectral.detrend`` along the last axis with held constants."""
    if type == "constant":
        return x - x.mean(dim=-1, keepdim=True)
    pinva, at = consts
    coef = _prx.p_einsum("cn,...n->...c", pinva, x)
    return x - _prx.p_einsum("nc,...c->...n", at, coef)


# ---------------------------------------------------------------------------
# sample-stream stages with carried state
# ---------------------------------------------------------------------------


class _FirStage(Stage):
    """Causal FIR (convolution or cross-correlation) with the
    overlap-save halo carried between blocks."""

    family = "convolve"

    def __init__(self, h, reverse: bool, name: str):
        super().__init__(name)
        self._h = np.asarray(_host64(h), np.float32)
        if self._h.ndim != 1 or self._h.shape[0] < 1:
            raise ValueError("h must be a non-empty 1D filter")
        self._k = int(self._h.shape[0])
        self._reverse = bool(reverse)
        self._carry = _cv.streaming_carry_len(self._k)
        self._h_dev = None

    def plan(self, block_in, mode):
        _require_mode(self, mode)
        if block_in < 1:
            raise ValueError("block must be positive")
        self._block_in = int(block_in)
        return int(block_in), mode

    def resolve(self, tune_stamp):
        ext = self._carry + self._block_in
        self.route = _cv.select_stream_route(
            ext, self._k,
            tune_geom=tune_stamp(
                {"x_length": routing.pow2_bucket(ext),
                 "h_length": self._k}))
        return self.route

    def place(self, dev):
        self._h_dev = _const(self._h, dev)

    def init_state(self, batch_shape):
        if self._carry == 0:
            return ()
        return np.zeros(tuple(batch_shape) + (self._carry,), np.float32)

    def apply(self, x, state):
        if self._carry == 0:
            return _cv.causal_stream_block(x, self._h_dev, self.route,
                                           reverse=self._reverse), ()
        ext = torch.cat([state, x], dim=-1)
        y = _cv.causal_stream_block(ext, self._h_dev, self.route,
                                    reverse=self._reverse)
        return y, ext[..., -self._carry:]

    def apply_na(self, x, state):
        if self._carry == 0:
            return _cv.causal_stream_block_na(
                x, self._h, reverse=self._reverse), ()
        ext = np.concatenate([_host64(state), _host64(x)], axis=-1)
        y = _cv.causal_stream_block_na(ext, self._h,
                                       reverse=self._reverse)
        return y, ext[..., -self._carry:]

    def oracle(self, x, block_in, mode):
        x = _host64(x)
        pre = np.zeros(x.shape[:-1] + (self._carry,), np.float64)
        return _cv.causal_stream_block_na(
            np.concatenate([pre, x], axis=-1), self._h,
            reverse=self._reverse)


class _SosfiltStage(Stage):
    """IIR second-order-section cascade with carried DF2T ``zi``."""

    def __init__(self, sos, name: str = "sosfilt"):
        super().__init__(name)
        self._sos = _iir._check_sos(_host64(sos))
        self._powers = None

    def plan(self, block_in, mode):
        _require_mode(self, mode)
        if block_in < 2:
            raise ValueError("sosfilt streaming needs blocks >= 2")
        self._block_in = int(block_in)
        return int(block_in), mode

    def place(self, dev):
        self._powers = _iir._stream_powers(self._sos, self._block_in, dev)

    def init_state(self, batch_shape):
        return np.zeros(tuple(batch_shape) + (len(self._sos), 2),
                        np.float32)

    def apply(self, x, state):
        return _iir.sos_stream_step(x, self._sos, state,
                                    powers=self._powers)

    def apply_na(self, x, state):
        return _iir.sos_stream_step_na(_host64(x), self._sos,
                                       _host64(state))

    def oracle(self, x, block_in, mode):
        return _iir.sosfilt_na(self._sos, _host64(x))


class _ResampleStage(Stage):
    """Rational polyphase resampler with carried input history; the
    centered anti-aliasing filter's lookahead appears as ``latency``
    pre-roll samples (see :func:`veles.simd_tpu_torch.ops.resample.\
resample_stream_plan`)."""

    def __init__(self, up: int, down: int, taps=None,
                 name: str = "resample_poly"):
        super().__init__(name)
        self._up, self._down, self._taps_arg = int(up), int(down), taps
        self._plan: dict | None = None
        self._runs = None

    def plan(self, block_in, mode):
        _require_mode(self, mode)
        self._plan = _rs.resample_stream_plan(self._up, self._down,
                                              int(block_in),
                                              self._taps_arg)
        self._block_in = int(block_in)
        self.latency = self._plan["preroll"]
        return self._plan["out_block"], mode

    def place(self, dev):
        self._runs = _rs._stream_runs(self._plan, dev)

    def init_state(self, batch_shape):
        return np.zeros(tuple(batch_shape) + (self._plan["hist"],),
                        np.float32)

    def apply(self, x, state):
        p = self._plan
        ext = torch.cat([state, x], dim=-1)
        y = _rs.resample_stream_step(ext, p["taps"], p, runs=self._runs)
        return y, ext[..., -p["hist"]:]

    def apply_na(self, x, state):
        ext = np.concatenate([_host64(state), _host64(x)], axis=-1)
        y = _rs.resample_stream_step_na(ext, self._plan)
        return y, ext[..., -self._plan["hist"]:]

    def oracle(self, x, block_in, mode):
        return _rs.resample_stream_oracle(_host64(x), self._plan)


class _MedfiltStage(Stage):
    """Centered sliding median with the ``k - 1`` halo carried; the
    center lookahead appears as ``k // 2`` pre-roll samples."""

    def __init__(self, kernel_size: int, name: str = "medfilt"):
        super().__init__(name)
        self._k = _fl._check_kernel(kernel_size)
        self.latency = self._k // 2

    def plan(self, block_in, mode):
        _require_mode(self, mode)
        if block_in < 1:
            raise ValueError("block must be positive")
        self._block_in = int(block_in)
        return int(block_in), mode

    def init_state(self, batch_shape):
        if self._k == 1:
            return ()
        return np.zeros(tuple(batch_shape) + (self._k - 1,),
                        np.float32)

    def apply(self, x, state):
        if self._k == 1:
            return x, ()
        ext = torch.cat([state, x], dim=-1)
        win = ext.unfold(-1, self._k, 1)       # [..., b, k] windows
        y = torch.sort(win, dim=-1).values[..., self._k // 2]
        return y, ext[..., -(self._k - 1):]

    def apply_na(self, x, state):
        if self._k == 1:
            return _host64(x), ()
        ext = np.concatenate([_host64(state), _host64(x)], axis=-1)
        b = np.shape(x)[-1]
        win = np.stack([ext[..., j:j + b] for j in range(self._k)],
                       axis=-1)
        y = np.sort(win, axis=-1)[..., self._k // 2]
        return y, ext[..., -(self._k - 1):]

    def oracle(self, x, block_in, mode):
        x = _host64(x)
        pre = np.zeros(x.shape[:-1] + (self._k // 2,), np.float64)
        y = _fl.medfilt_na(np.concatenate([pre, x], axis=-1), self._k)
        return y[..., :x.shape[-1]]


class _StftStage(Stage):
    """Short-time Fourier transform with the frame overlap carried;
    emits ``block/hop`` complex frames per block and switches the
    chain into ``"frames"`` mode."""

    family = "stft"

    def __init__(self, frame_length: int, hop: int, window=None,
                 name: str = "stft"):
        super().__init__(name)
        self._L, self._hop = int(frame_length), int(hop)
        self._carry = _sp.stft_stream_carry(self._L, self._hop)
        self._window = _sp._resolve_window(window, self._L)
        self.latency = self._L // self._hop - 1  # pre-roll frames
        self._op = None

    def plan(self, block_in, mode):
        _require_mode(self, mode)
        if block_in % self._hop != 0 or block_in < self._hop:
            raise ValueError(
                f"stft stage needs hop {self._hop} dividing the "
                f"block, got block {block_in}")
        self._block_in = int(block_in)
        self._frames = block_in // self._hop
        return self._L // 2 + 1, "frames"

    def resolve(self, tune_stamp):
        self.route = _sp.select_stft_stream_route(
            self._L, self._hop, self._frames,
            tune_geom=tune_stamp({"frame_length": self._L,
                                  "hop": self._hop}))
        return self.route

    def place(self, dev):
        self._op = _sp._stft_stream_operand(self._L, self._window,
                                            self.route, dev)

    def init_state(self, batch_shape):
        if self._carry == 0:
            return ()
        return np.zeros(tuple(batch_shape) + (self._carry,),
                        np.float32)

    def apply(self, x, state):
        ext = x if self._carry == 0 else torch.cat([state, x], dim=-1)
        spec = _sp.stft_stream_step(ext, self._L, self._hop, self._window,
                                    self.route, operand=self._op)
        new = () if self._carry == 0 else ext[..., -self._carry:]
        return spec, new

    def apply_na(self, x, state):
        x = _host64(x)
        ext = (x if self._carry == 0
               else np.concatenate([_host64(state), x], axis=-1))
        spec = _sp.stft_na(ext, self._L, self._hop, self._window)
        new = () if self._carry == 0 else ext[..., -self._carry:]
        return spec, new

    def oracle(self, x, block_in, mode):
        return _sp.stft_stream_oracle(_host64(x), self._L, self._hop,
                                      self._window)


# ---------------------------------------------------------------------------
# blockwise / per-row stages (stateless)
# ---------------------------------------------------------------------------


class _DetrendStage(Stage):
    """Least-squares de-trending.  In ``samples`` mode this is
    BLOCK-WISE detrending (each block's own trend removed — the
    always-on monitoring semantics); in frame/row modes it detrends
    each row."""

    def __init__(self, type: str = "linear",  # noqa: A002
                 name: str = "detrend"):
        super().__init__(name)
        if type not in ("linear", "constant"):
            raise ValueError(f"type must be 'linear' or 'constant', "
                             f"got {type!r}")
        self._type = type
        self._consts = None

    def plan(self, block_in, mode):
        self._block_in = int(block_in)
        self._mode = mode
        return int(block_in), mode

    def place(self, dev):
        if self._type == "linear":
            self._consts = _detrend_consts(self._block_in, dev)

    def apply(self, x, state):
        return _detrend_t(x, self._type, self._consts), ()

    def apply_na(self, x, state):
        return _sp.detrend_na(_host64(x), self._type), ()

    def oracle(self, x, block_in, mode):
        x = _host64(x)
        if mode != "samples":
            return _sp.detrend_na(x, self._type)
        blocked = x.reshape(x.shape[:-1] + (-1, block_in))
        out = _sp.detrend_na(blocked, self._type)
        return out.reshape(x.shape)


class _WelchStage(Stage):
    """Per-block Welch PSD: every block yields one averaged one-sided
    periodogram row — the chain switches into ``"rows"`` mode (the
    always-on spectral monitor's heartbeat)."""

    def __init__(self, fs: float = 1.0, nperseg: int = 256,
                 noverlap=None, window=None,
                 detrend_type: str = "constant",
                 scaling: str = "density", name: str = "welch"):
        super().__init__(name)
        self._kw = dict(fs=float(fs), nperseg=int(nperseg),
                        noverlap=noverlap, window=window,
                        detrend_type=detrend_type, scaling=scaling)
        self.freqs = None
        self._dev = None

    def plan(self, block_in, mode):
        _require_mode(self, mode)
        if block_in < self._kw["nperseg"]:
            raise ValueError(
                f"welch stage needs blocks >= nperseg "
                f"{self._kw['nperseg']}, got {block_in}")
        self._block_in = int(block_in)
        self.freqs = np.fft.rfftfreq(self._kw["nperseg"],
                                     1.0 / self._kw["fs"])
        return self._kw["nperseg"] // 2 + 1, "rows"

    def place(self, dev):
        # spectral.welch's segment pipeline, its constants held here
        kw = self._kw
        nperseg, hop, window = _sp._welch_args(
            self._block_in, kw["nperseg"], kw["noverlap"], kw["window"])
        scale = _sp._onesided_scale(nperseg, kw["fs"], window,
                                    kw["scaling"])
        consts = (_detrend_consts(nperseg, dev)
                  if kw["detrend_type"] == "linear" else None)
        self._dev = (nperseg, hop, _const(window, dev),
                     _const(scale, dev), consts)

    def apply(self, x, state):
        nperseg, hop, window, scale, consts = self._dev
        segs = _sp._take_frames(x, nperseg, hop)
        if self._kw["detrend_type"] is not None:
            segs = _detrend_t(segs, self._kw["detrend_type"], consts)
        fx = torch.fft.rfft(segs * window, dim=-1)
        pxx = (fx.abs() ** 2).mean(dim=-2) * scale
        return pxx.to(torch.float32), ()

    def apply_na(self, x, state):
        _, pxx = _sp.welch_na(_host64(x), **self._kw)
        return pxx, ()

    def oracle(self, x, block_in, mode):
        x = _host64(x)
        blocked = x.reshape(x.shape[:-1] + (-1, block_in))
        _, pxx = _sp.welch_na(blocked, **self._kw)
        return pxx


class _PowerStage(Stage):
    """Pointwise power ``|x|^2`` (complex STFT frames -> real power);
    inherits the chain mode."""

    def __init__(self, name: str = "power"):
        super().__init__(name)

    def plan(self, block_in, mode):
        self._block_in = int(block_in)
        return int(block_in), mode

    def apply(self, x, state):
        if x.is_complex():
            return (x.real ** 2 + x.imag ** 2).to(torch.float32), ()
        return (x * x).to(torch.float32), ()

    def apply_na(self, x, state):
        x = to_host(x)
        return np.real(x) ** 2 + np.imag(x) ** 2, ()

    def oracle(self, x, block_in, mode):
        return self.apply_na(x, ())[0]


class _PowerDbStage(Stage):
    """Pointwise ``10 log10(max(x, floor))`` — dB view of a power row;
    inherits the chain mode."""

    def __init__(self, floor: float = 1e-12, name: str = "power_db"):
        super().__init__(name)
        self._floor = float(floor)

    def plan(self, block_in, mode):
        self._block_in = int(block_in)
        return int(block_in), mode

    def apply(self, x, state):
        return 10.0 * torch.log10(torch.clamp(x, min=self._floor)), ()

    def apply_na(self, x, state):
        x = _host64(x)
        return 10.0 * np.log10(np.maximum(x, self._floor)), ()

    def oracle(self, x, block_in, mode):
        return self.apply_na(x, ())[0]


class _SavgolStage(Stage):
    """Savitzky-Golay smoothing along the last axis — a per-row
    operator for PSD/frame rows (``mode='interp'`` fits its edges on
    the host and cannot run inside the step; the streaming form uses
    ``'nearest'``/``'constant'``)."""

    def __init__(self, window_length: int, polyorder: int,
                 deriv: int = 0, delta: float = 1.0,
                 mode: str = "nearest", name: str = "savgol"):
        super().__init__(name)
        if mode not in ("nearest", "constant"):
            raise ValueError(
                "pipeline savgol supports mode='nearest'/'constant' "
                "(mode='interp' fits edges host-side and cannot fuse)")
        self._args = (int(window_length), int(polyorder), int(deriv),
                      float(delta), mode)
        _fl._check_kernel(int(window_length), "window_length")
        self._taps = None

    def plan(self, block_in, mode):
        if mode == "samples":
            raise ValueError(
                f"stage {self.name!r} is a per-row smoother — placed "
                "in a samples-mode chain its window would ignore "
                "block boundaries; put it after a frames/rows stage")
        w = self._args[0]
        if block_in < w:
            raise ValueError(f"savgol window {w} exceeds row length "
                             f"{block_in}")
        self._block_in = int(block_in)
        return int(block_in), mode

    def place(self, dev):
        w, p, d, delta, _ = self._args
        self._taps = _const(_fl._savgol_corr_taps(w, p, d, delta),
                            dev).view(1, 1, -1)

    def apply(self, x, state):
        # filters.savgol_filter's 'nearest'/'constant' body
        w, mode = self._args[0], self._args[4]
        half = w // 2
        if mode == "nearest":
            lead = tuple(x.shape[:-1])
            xe = torch.cat([x[..., :1].expand(*lead, half), x,
                            x[..., -1:].expand(*lead, half)], dim=-1)
        else:
            xe = F.pad(x, (half, half))
        with _prx.fp32_conv(x.device):
            out = F.conv1d(xe.reshape(-1, 1, xe.shape[-1]), self._taps)
        return out.reshape(x.shape), ()

    def apply_na(self, x, state):
        w, p, d, delta, mode = self._args
        return _fl.savgol_filter_na(_host64(x), w, p, deriv=d,
                                    delta=delta, mode=mode), ()

    def oracle(self, x, block_in, mode):
        return self.apply_na(x, ())[0]


class _DetectPeaksStage(Stage):
    """Fixed-capacity local-extrema read-off along the last axis —
    the terminal alerting stage.  Emits the tuple ``(positions,
    values, count)`` per block (positions ``int32`` padded with -1)."""

    terminal = True

    def __init__(self, type=_dp.ExtremumType.MAXIMUM,  # noqa: A002
                 max_peaks: int = 64, name: str = "detect_peaks"):
        super().__init__(name)
        self._type = _dp.ExtremumType(int(type))
        self._max = int(max_peaks)
        if self._max < 1:
            raise ValueError("max_peaks must be >= 1")

    def plan(self, block_in, mode):
        if block_in < 3:
            raise ValueError("detect_peaks needs rows of >= 3 samples")
        self._block_in = int(block_in)
        return self._max, mode

    def apply(self, x, state):
        return _dp._peaks_fixed(x, self._type, self._max), ()

    def apply_na(self, x, state):
        d = _host64(x)
        n = d.shape[-1]
        prev, curr, nxt = d[..., :-2], d[..., 1:-1], d[..., 2:]
        d1, d2 = curr - prev, curr - nxt
        is_ext = (d1 * d2) > 0
        want = np.zeros_like(is_ext)
        if self._type & _dp.ExtremumType.MAXIMUM:
            want |= d1 > 0
        if self._type & _dp.ExtremumType.MINIMUM:
            want |= d1 < 0
        pad = [(0, 0)] * (d.ndim - 1) + [(1, 1)]
        mask = np.pad(is_ext & want, pad)
        flat_m = mask.reshape(-1, n)
        flat_d = d.reshape(-1, n)
        pos = np.full((flat_m.shape[0], self._max), -1, np.int32)
        vals = np.zeros((flat_m.shape[0], self._max), np.float64)
        for r in range(flat_m.shape[0]):
            idx = np.nonzero(flat_m[r])[0][: self._max]
            pos[r, : len(idx)] = idx
            vals[r, : len(idx)] = flat_d[r, idx]
        shape = d.shape[:-1] + (self._max,)
        count = mask.sum(axis=-1)
        return (pos.reshape(shape), vals.reshape(shape), count), ()

    def oracle(self, x, block_in, mode):
        return self.apply_na(x, ())[0]


# ---------------------------------------------------------------------------
# factory functions — the public chain-declaration vocabulary
# ---------------------------------------------------------------------------


def fir(h, name: str = "fir") -> Stage:
    """Causal FIR filter stage (overlap-save halo carried between
    blocks); kernel resolved through the ``convolve`` routing family
    at compile time."""
    return _FirStage(h, reverse=False, name=name)


def correlate(h, name: str = "correlate") -> Stage:
    """Causal cross-correlation stage (the matched filter): the FIR
    link with the template un-flipped."""
    return _FirStage(h, reverse=True, name=name)


def matched_filter(template, name: str = "matched_filter") -> Stage:
    """Alias of :func:`correlate` for the radar/biosignal idiom."""
    return _FirStage(template, reverse=True, name=name)


def sosfilt(sos, name: str = "sosfilt") -> Stage:
    """IIR cascade stage with carried DF2T ``zi`` state."""
    return _SosfiltStage(sos, name=name)


def resample_poly(up: int, down: int, taps=None,
                  name: str = "resample_poly") -> Stage:
    """Rational polyphase resampler stage with carried input history
    (``block * up`` must divide by ``down``)."""
    return _ResampleStage(up, down, taps=taps, name=name)


def medfilt(kernel_size: int, name: str = "medfilt") -> Stage:
    """Centered sliding-median despiker with carried halo."""
    return _MedfiltStage(kernel_size, name=name)


def detrend(type: str = "linear",  # noqa: A002
            name: str = "detrend") -> Stage:
    """Block-wise (or per-row) least-squares detrending stage."""
    return _DetrendStage(type, name=name)


def stft(frame_length: int, hop: int, window=None,
         name: str = "stft") -> Stage:
    """STFT stage with carried frame overlap; kernel resolved through
    the ``stft`` routing family at compile time.  Switches the chain
    into ``frames`` mode."""
    return _StftStage(frame_length, hop, window=window, name=name)


def power(name: str = "power") -> Stage:
    """Pointwise ``|x|^2`` stage (complex frames -> real power)."""
    return _PowerStage(name=name)


def power_db(floor: float = 1e-12, name: str = "power_db") -> Stage:
    """Pointwise ``10 log10(max(x, floor))`` stage."""
    return _PowerDbStage(floor, name=name)


def welch(fs: float = 1.0, nperseg: int = 256, noverlap=None,
          window=None, detrend_type: str = "constant",
          scaling: str = "density", name: str = "welch") -> Stage:
    """Per-block Welch PSD stage (one averaged periodogram row per
    block).  Switches the chain into ``rows`` mode."""
    return _WelchStage(fs, nperseg, noverlap, window, detrend_type,
                       scaling, name=name)


def savgol(window_length: int, polyorder: int, deriv: int = 0,
           delta: float = 1.0, mode: str = "nearest",
           name: str = "savgol") -> Stage:
    """Savitzky-Golay per-row smoothing stage (PSD/frame rows)."""
    return _SavgolStage(window_length, polyorder, deriv=deriv,
                        delta=delta, mode=mode, name=name)


def detect_peaks(type=_dp.ExtremumType.MAXIMUM,  # noqa: A002
                 max_peaks: int = 64,
                 name: str = "detect_peaks") -> Stage:
    """Terminal fixed-capacity peak read-off stage: emits
    ``(positions, values, count)`` per block."""
    return _DetectPeaksStage(type, max_peaks, name=name)
