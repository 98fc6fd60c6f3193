"""IIR filtering: filter design, biquad cascades, transfer functions,
zero-phase filtering.

The port of ``veles.simd_tpu.ops.iir`` (the JAX package's addition
beyond the reference, whose filters are all finite), computed with
PyTorch on ``Config.device``:

* **Design is host-side float64 NumPy**, copied from the JAX package:
  the Butterworth, Chebyshev I/II, Bessel and elliptic families, the
  notch and peak biquads, the order estimators, the ba / zpk / sos
  converters, the responses and the steady states.  Coefficients are a
  few dozen scalars; only their float32 transition powers (below) go
  to the device, once per filter.
* **The recurrence is a log-depth doubling scan.**  An order-p section
  is the state recurrence ``s[t] = A s[t-1] + (u[t], 0, ...)`` with a
  companion matrix ``A`` that is the same at every step and ``u`` the
  FIR drive (shifted adds).  So level j of the scan adds
  ``A^(2^j) s[t - 2^j]`` to every ``s[t]`` (j = 0 .. ceil(log2 n) - 1):
  n·p floats per level where the JAX package's ``associative_scan``
  over (A, u) pairs carries n·p².  The powers are squared on the host
  in float64 and rounded once to float32, and each level is p
  elementwise fp32 multiply-adds: no matmul, so no TF32 on the card.
  The powers stop at the first that rounds to zero in float32: every
  later one is its square, and adds exactly zero.
* **The DF2T state convention is the JAX package's** (scipy's
  ``sosfilt_zi``): an incoming ``(z1, z2)`` corrects y[0] and y[1] of
  the drive, and the exit state comes from the last two samples.

scipy.signal conventions throughout.  Oracle twins (``*_na``) run the
sequential textbook recurrence in float64 NumPy, a different algorithm
from the scan.  Results are float32 tensors on the input's device;
``simd=False`` returns NumPy as the JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils.cache import ConstantCache
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = [
    "butterworth", "cheby1", "cheby2", "bessel", "ellip", "iirnotch",
    "iirpeak", "buttord", "cheb1ord", "cheb2ord", "ellipord",
    "tf2zpk", "zpk2tf", "zpk2sos", "tf2sos", "sos2tf", "group_delay",
    "filtfilt", "sosfilt",
    "sosfilt_na",
    "sosfiltfilt", "sosfiltfilt_na", "lfilter", "lfilter_na",
    "sos_frequency_response", "frequency_response", "sosfilt_zi",
    "lfilter_zi", "StreamingSosfilt", "sos_stream_step",
    "sos_stream_step_na",
]


# ---------------------------------------------------------------------------
# design (host-side float64)
# ---------------------------------------------------------------------------


def _butter_analog_poles(order: int) -> np.ndarray:
    """Left-half-plane poles of the analog Butterworth prototype
    (|p| = 1, maximally flat)."""
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order) + np.pi / 2
    return np.exp(1j * theta)


def _bilinear_zpk(z, p, k, fs: float):
    """Bilinear s->z transform of a zero/pole/gain analog filter."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    # zeros at analog infinity land at z = -1
    zd = np.append(zd, -np.ones(len(p) - len(z)))
    kd = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zd, pd, kd


def _zpk_to_sos(z, p, k) -> np.ndarray:
    """Pair conjugate roots into second-order sections [n_sections, 6].

    Simple pairing (conjugate pairs together, leftover reals paired in
    order, overall gain on the first section): section ordering affects
    fixed-point scaling, not the float transfer function the tests pin.
    """
    def _pair(roots):
        roots = sorted(np.asarray(roots, complex),
                       key=lambda r: (abs(r.imag) < 1e-12, r.real,
                                      abs(r.imag)))
        used = [False] * len(roots)
        pairs = []
        for i, r in enumerate(roots):
            if used[i]:
                continue
            used[i] = True
            if abs(r.imag) > 1e-12:
                # find its conjugate
                for j in range(i + 1, len(roots)):
                    if not used[j] and abs(roots[j] - r.conjugate()) < 1e-8:
                        used[j] = True
                        pairs.append((r, r.conjugate()))
                        break
                else:
                    raise ValueError(f"unpaired complex root {r}")
            else:
                # real root: pair with the next unused real (or alone)
                mate = None
                for j in range(i + 1, len(roots)):
                    if not used[j] and abs(roots[j].imag) < 1e-12:
                        used[j] = True
                        mate = roots[j]
                        break
                pairs.append((r, mate))
        return pairs

    # degree-match with roots at the ORIGIN (scipy's convention: an
    # origin zero/pole is b or a = [1, 0], a pure coefficient shift the
    # shared roll below cancels) — this makes FIR inputs (no poles) and
    # fewer-zeros-than-poles inputs exact, with no spurious delay
    z = np.concatenate([np.asarray(z, complex),
                        np.zeros(max(0, len(p) - len(z)), complex)])
    p = np.concatenate([np.asarray(p, complex),
                        np.zeros(max(0, len(z) - len(p)), complex)])
    zp, pp = _pair(z), _pair(p)
    sos = []
    for (z1, z2), (p1, p2) in zip(zp, pp):
        def _poly(r1, r2):
            # degree matching guarantees r1 exists for every pair
            assert r1 is not None
            if r2 is None:
                return np.array([0.0, 1.0, -r1.real])
            c = np.poly([r1, r2])
            return np.real(c)
        b = _poly(z1, z2)
        a = _poly(p1, p2)
        # normalize to a leading 1 in a (a[0] may be 0 for first-order)
        nz = np.nonzero(np.abs(a) > 0)[0][0]
        sos.append(np.concatenate([np.roll(b, -nz), np.roll(a, -nz)]))
    sos = np.asarray(sos, np.float64)
    sos[0, :3] *= k
    return sos


def butterworth(order: int, cutoff, btype: str = "lowpass") -> np.ndarray:
    """Digital Butterworth filter as second-order sections.

    ``cutoff`` is the -3 dB edge as a fraction of the Nyquist frequency
    (scipy's ``Wn``): a scalar for ``lowpass``/``highpass``, a
    ``(low, high)`` pair for ``bandpass``/``bandstop``.  Returns
    ``[n_sections, 6]`` float64 rows ``[b0, b1, b2, 1, a1, a2]`` for
    :func:`sosfilt`.  Matches ``scipy.signal.butter(..., output='sos')``
    up to section pairing (same transfer function).
    """
    p = _butter_analog_poles(_check_order(order))
    k = float(np.real(np.prod(-p)))  # unit DC gain prototype (= 1 here)
    return _prototype_to_digital_sos(np.array([], complex), p, k, cutoff,
                                     btype)


def _check_order(order) -> int:
    order = int(order)
    if order < 1:
        raise ValueError("order must be >= 1")
    return order


def _prototype_to_digital_sos(z, p, k, cutoff, btype) -> np.ndarray:
    """Analog lowpass prototype (zpk, edge at 1 rad/s) -> digital SOS:
    pre-warp, general lp2lp/hp/bp/bs zpk transform (finite zeros
    supported — Chebyshev II needs them), bilinear, pair."""
    btype = btype.lower()
    fs = 2.0  # Nyquist = 1, scipy's normalized convention
    z = np.asarray(z, complex)
    p = np.asarray(p, complex)
    degree = len(p) - len(z)
    if degree < 0:
        raise ValueError("prototype has more zeros than poles")
    if btype in ("lowpass", "highpass"):
        wn = float(np.squeeze(cutoff))
        if not 0.0 < wn < 1.0:
            raise ValueError(f"cutoff {wn} must be in (0, 1)")
        wo = 2 * fs * math.tan(math.pi * wn / fs)
        if btype == "lowpass":      # s -> s / wo
            z, p = z * wo, p * wo
            k = k * wo ** degree
        else:                        # lp2hp: s -> wo / s
            zp, pp = z, p            # (prod of an empty array is 1.0)
            z = np.append(wo / zp, np.zeros(degree))
            p = wo / pp
            k = k * np.real(np.prod(-zp) / np.prod(-pp))
    elif btype in ("bandpass", "bandstop"):
        lo, hi = (float(c) for c in np.ravel(cutoff))
        if not 0.0 < lo < hi < 1.0:
            raise ValueError(f"band edges ({lo}, {hi}) must satisfy "
                             "0 < low < high < 1")
        w1 = 2 * fs * math.tan(math.pi * lo / fs)
        w2 = 2 * fs * math.tan(math.pi * hi / fs)
        bw, wo = w2 - w1, math.sqrt(w1 * w2)

        def _split(r, scale_first):
            rs = (r * bw / 2) if scale_first else ((bw / 2) / r)
            return np.concatenate([rs + np.sqrt(rs ** 2 - wo ** 2),
                                   rs - np.sqrt(rs ** 2 - wo ** 2)])

        if btype == "bandpass":     # s -> (s^2 + wo^2) / (bw s)
            z = np.append(_split(z, True), np.zeros(degree))
            p = _split(p, True)
            k = k * bw ** degree
        else:                        # lp2bs: s -> (bw s) / (s^2 + wo^2)
            zp, pp = z, p
            z = np.append(_split(zp, False),
                          np.concatenate([1j * wo * np.ones(degree),
                                          -1j * wo * np.ones(degree)]))
            p = _split(pp, False)
            k = k * np.real(np.prod(-zp) / np.prod(-pp))
    else:
        raise ValueError(f"unknown btype {btype!r}")
    zd, pd, kd = _bilinear_zpk(z, p, k, fs)
    return _zpk_to_sos(zd, pd, kd)


def bessel(order: int, cutoff, btype: str = "lowpass") -> np.ndarray:
    """Bessel/Thomson digital filter as SOS (scipy's ``bessel(...,
    norm='phase', output='sos')``): maximally-flat GROUP DELAY — the
    design for pulse shapes that must not ring.  ``cutoff`` marks the
    phase-normalized characteristic frequency (scipy's default norm),
    as a fraction of Nyquist.

    The analog prototype's poles are the roots of the reverse Bessel
    polynomial ``theta_n(s) = sum_k (2n-k)! / (2^(n-k) k! (n-k)!) s^k``
    scaled by ``a_0^(-1/n)`` (the phase normalization), all host-side
    float64.
    """
    order = _check_order(order)
    coeffs = [math.factorial(2 * order - k)
              / (2 ** (order - k) * math.factorial(k)
                 * math.factorial(order - k))
              for k in range(order + 1)]
    p = np.roots(coeffs[::-1]) / coeffs[0] ** (1.0 / order)
    k = float(np.real(np.prod(-p)))  # == 1 by the normalization
    return _prototype_to_digital_sos(np.array([], complex), p, k, cutoff,
                                     btype)


def cheby1(order: int, rp: float, cutoff,
           btype: str = "lowpass") -> np.ndarray:
    """Chebyshev type-I digital filter as second-order sections
    (scipy's ``cheby1(..., output='sos')``): equiripple passband
    (``rp`` dB of ripple), monotone stopband, sharper rolloff than
    Butterworth at the same order.  ``cutoff`` marks the END of the
    ripple band (scipy convention), as a fraction of Nyquist.
    """
    order = _check_order(order)
    rp = float(rp)
    if rp <= 0:
        raise ValueError("rp (passband ripple, dB) must be > 0")
    eps = math.sqrt(10.0 ** (rp / 10.0) - 1.0)
    mu = math.asinh(1.0 / eps) / order
    kk = np.arange(1, order + 1)
    theta = math.pi * (2 * kk - 1) / (2 * order)
    p = -math.sinh(mu) * np.sin(theta) + 1j * math.cosh(mu) * np.cos(theta)
    k = np.real(np.prod(-p))
    if order % 2 == 0:  # even orders dip: DC gain is -rp dB
        k /= math.sqrt(1.0 + eps ** 2)
    return _prototype_to_digital_sos(np.array([], complex), p, k, cutoff,
                                     btype)


def cheby2(order: int, rs: float, cutoff,
           btype: str = "lowpass") -> np.ndarray:
    """Chebyshev type-II (inverse Chebyshev) digital filter as SOS
    (scipy's ``cheby2(..., output='sos')``): monotone passband,
    equiripple stopband ``rs`` dB down.  ``cutoff`` marks the START of
    the stopband (scipy convention), as a fraction of Nyquist.
    """
    order = _check_order(order)
    rs = float(rs)
    if rs <= 0:
        raise ValueError("rs (stopband attenuation, dB) must be > 0")
    eps = 1.0 / math.sqrt(10.0 ** (rs / 10.0) - 1.0)
    mu = math.asinh(1.0 / eps) / order
    kk = np.arange(1, order + 1)
    theta = math.pi * (2 * kk - 1) / (2 * order)
    # type-I poles, then invert to move the ripple to the stopband
    p1 = -math.sinh(mu) * np.sin(theta) \
        + 1j * math.cosh(mu) * np.cos(theta)
    p = 1.0 / p1
    # zeros on the imaginary axis at the ripple frequencies (the odd
    # order's cos(pi/2) = 0 zero-at-infinity is dropped)
    ct = np.cos(theta)
    ct = ct[np.abs(ct) > 1e-12]
    z = 1j / ct
    k = np.real(np.prod(-p) / np.prod(-z))
    return _prototype_to_digital_sos(z, p, k, cutoff, btype)


# -- elliptic (Cauer) design machinery: complete elliptic integrals via
#    the AGM, Jacobi sn/cn/dn via the descending Landen/Gauss
#    transformation (Abramowitz & Stegun 16.4 / 16.12), and scalar
#    bisection for the two transcendental solves.  All host-side
#    float64, a few dozen scalars per design.


def _agm(a: float, b: float) -> float:
    # tolerance must sit above 1 ulp (2.2e-16 relative) or the loop
    # never exits; quadratic convergence makes the last step exact
    while abs(a - b) > 4e-16 * a:
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return a


def _ellipk(m: float) -> float:
    """Complete elliptic integral K(m) (PARAMETER m = modulus^2, scipy
    convention): pi / (2 agm(1, sqrt(1-m)))."""
    if not 0.0 <= m < 1.0:
        raise ValueError(f"parameter m={m} must be in [0, 1)")
    return math.pi / (2.0 * _agm(1.0, math.sqrt(1.0 - m)))


def _ellipkp(m: float) -> float:
    """Complementary integral K'(m) = K(1-m), computed from ``m``
    directly so tiny moduli don't round 1-m to 1.0."""
    if not 0.0 < m <= 1.0:
        raise ValueError(f"parameter m={m} must be in (0, 1]")
    return math.pi / (2.0 * _agm(1.0, math.sqrt(m)))


def _ellipj(u, m: float, mc: float | None = None):
    """Jacobi elliptic (sn, cn, dn)(u | m), vectorized over ``u``.

    Descending Landen ladder: run the AGM down to the circular case,
    evaluate sin/cos there, then climb back up with the Gauss ascending
    recurrence (A&S 16.12.2-4).  ``mc`` optionally supplies the
    complementary parameter 1-m exactly (the inverse-sc solve needs
    parameter 1-m1 with m1 tiny, where forming 1-m loses it).
    """
    u = np.asarray(u, np.float64)
    if mc is None:
        mc = 1.0 - m
    if m == 0.0:
        return np.sin(u), np.cos(u), np.ones_like(u)
    if mc <= 0.0:
        sech = 1.0 / np.cosh(u)
        return np.tanh(u), sech, sech
    # AGM ladder a_{k+1} = (a_k+b_k)/2, c_{k+1} = (a_k-b_k)/2; keep the
    # ratios c_k/a_k for k = 1..N that the descent needs
    a, b = 1.0, math.sqrt(mc)
    ratios = []
    while True:
        a_next, b_next = 0.5 * (a + b), math.sqrt(a * b)
        c_next = 0.5 * (a - b)
        ratios.append(c_next / a_next)
        a, b = a_next, b_next
        if c_next <= 1e-15 * a_next:
            break
    phi = (2.0 ** len(ratios)) * a * u
    for ra in reversed(ratios):
        # A&S 16.12.2: sin(2 phi_{k-1} - phi_k) = (c_k/a_k) sin(phi_k)
        phi = 0.5 * (phi + np.arcsin(
            np.clip(ra * np.sin(phi), -1.0, 1.0)))
    sn = np.sin(phi)
    cn = np.cos(phi)
    dn = np.sqrt(np.maximum(1.0 - (1.0 - mc) * sn * sn, 0.0))
    return sn, cn, dn


def _bisect(f, lo: float, hi: float, iters: int = 200) -> float:
    """Plain bisection for a monotone-bracketed root (float64-exact
    after ~60 halvings; extra iterations are free at design time)."""
    flo = f(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if mid == lo or mid == hi:
            break
        if (f(mid) > 0) == (flo > 0):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _ellip_analog_zpk(order: int, rp: float, rs: float):
    """Analog elliptic lowpass prototype (passband edge 1 rad/s):
    equiripple in BOTH bands.  The construction scipy's ``ellipap``
    uses — degree equation for the transition modulus, Jacobi-function
    pole/zero placement on the elliptic grid."""
    eps_sq = 10.0 ** (0.1 * rp) - 1.0
    eps = math.sqrt(eps_sq)
    # ripple modulus m1 = (eps_p / eps_s)^2
    m1 = eps_sq / (10.0 ** (0.1 * rs) - 1.0)
    if m1 <= 0.0 or m1 >= 1.0:
        raise ValueError("need rs > rp (stopband deeper than passband "
                         "ripple)")
    k_m1 = _ellipk(m1)
    kp_m1 = _ellipkp(m1)
    krat = order * k_m1 / kp_m1
    # degree equation: find m with K(m)/K'(m) = krat (monotone in m)
    m = _bisect(
        lambda mm: _ellipk(mm) / _ellipkp(mm) - krat,
        1e-300, 1.0 - 1e-16)
    capk = _ellipk(m)
    j = np.arange(1 - order % 2, order, 2, dtype=np.float64)
    s, c, d = _ellipj(j * capk / order, m)
    # zeros at +-j / (sqrt(m) sn(j K / N)); drop the odd order's
    # sn(0) = 0 zero-at-infinity
    snz = s[np.abs(s) > 1e-14]
    z = 1j / (math.sqrt(m) * snz)
    z = np.concatenate([z, np.conj(z)])
    # v0 from the inverse sc with COMPLEMENTARY modulus (scipy's
    # _arc_jac_sc1, from sn(i z | m1) = i sc(z | 1-m1)):
    # solve sc(r | 1-m1) = 1/eps, r in (0, K(1-m1)) where sc is
    # monotone 0 -> inf
    r = _bisect(
        lambda u: (lambda sn_, cn_, _:
                   sn_ / cn_ - 1.0 / eps)(
                       *_ellipj(u, 1.0 - m1, mc=m1)),
        1e-300, kp_m1 * (1.0 - 1e-14))
    v0 = capk * r / (order * k_m1)
    sv, cv, dv = _ellipj(v0, 1.0 - m)
    p = -(c * d * sv * cv + 1j * s * dv) / (1.0 - (d * sv) ** 2)
    if order % 2:
        # the j=0 pole is real; the rest pair with their conjugates
        real_mask = np.abs(p.imag) <= 1e-14 * np.abs(p)
        p = np.concatenate([p, np.conj(p[~real_mask])])
    else:
        p = np.concatenate([p, np.conj(p)])
    k = np.real(np.prod(-p) / np.prod(-z))
    if order % 2 == 0:
        k /= math.sqrt(1.0 + eps_sq)
    return z, p, float(k)


def ellip(order: int, rp: float, rs: float, cutoff,
          btype: str = "lowpass") -> np.ndarray:
    """Elliptic (Cauer) digital filter as second-order sections
    (scipy's ``ellip(..., output='sos')``): equiripple in BOTH bands —
    ``rp`` dB of passband ripple, stopband at least ``rs`` dB down —
    the steepest possible rolloff for a given order.  ``cutoff`` marks
    the end of the passband ripple (scipy convention), as a fraction
    of Nyquist.
    """
    order = _check_order(order)
    rp, rs = float(rp), float(rs)
    if rp <= 0:
        raise ValueError("rp (passband ripple, dB) must be > 0")
    if rs <= rp:
        raise ValueError("rs (stopband attenuation, dB) must exceed rp")
    if order == 1:
        # degenerate: no finite zeros; scipy reduces to Chebyshev I
        return cheby1(1, rp, cutoff, btype)
    z, p, k = _ellip_analog_zpk(order, rp, rs)
    return _prototype_to_digital_sos(z, p, k, cutoff, btype)


def _notch_peak_sos(w0: float, Q: float, peak: bool) -> np.ndarray:
    """Single-biquad notch/peak at ``w0`` (fraction of Nyquist) with
    quality factor ``Q`` (scipy ``iirnotch``/``iirpeak``): -3 dB
    bandwidth ``w0/Q``, unit gain away from (notch) or at (peak) the
    center frequency."""
    w0 = float(w0)
    Q = float(Q)
    if not 0.0 < w0 < 1.0:
        raise ValueError(f"w0 {w0} must be in (0, 1) (Nyquist = 1)")
    if Q <= 0:
        raise ValueError("Q must be > 0")
    wr = w0 * math.pi
    beta = math.tan(w0 * math.pi / (2.0 * Q))  # GB = 1/sqrt(2)
    gain = 1.0 / (1.0 + beta)
    if peak:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    else:
        b = gain * np.array([1.0, -2.0 * math.cos(wr), 1.0])
    a1 = -2.0 * gain * math.cos(wr)
    a2 = 2.0 * gain - 1.0
    return np.array([[b[0], b[1], b[2], 1.0, a1, a2]], np.float64)


# -- representation conversions (scipy's tf2zpk/zpk2tf/tf2sos/sos2tf/
#    zpk2sos family + group_delay): the plumbing a user porting a
#    scipy.signal pipeline needs to move between the ba / zpk / sos
#    forms this module's designers and runners use.  Host-side float64.


def tf2zpk(b, a):
    """Transfer-function numerator/denominator to (zeros, poles, gain)
    — scipy's ``tf2zpk``: leading coefficients normalized out into the
    gain, roots via the companion eigenvalues (``np.roots``)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b, a = _normalize_ba(b, a)
    b = np.trim_zeros(b, "f")   # leading zeros shift degree, like scipy
    p = np.roots(a) if len(a) > 1 else np.array([], complex)
    if len(b) == 0:
        return np.array([], complex), p, 0.0
    k = b[0]
    z = np.roots(b / k) if len(b) > 1 else np.array([], complex)
    return z, p, float(k)


def zpk2tf(z, p, k):
    """(zeros, poles, gain) to ``(b, a)`` polynomial coefficients
    (scipy's ``zpk2tf``): real outputs when roots pair conjugately."""
    b = float(k) * np.poly(np.asarray(z, complex))
    a = np.poly(np.asarray(p, complex))
    if np.allclose(b.imag, 0, atol=1e-12):
        b = b.real
    if np.allclose(a.imag, 0, atol=1e-12):
        a = a.real
    return np.atleast_1d(b), np.atleast_1d(a)


def zpk2sos(z, p, k) -> np.ndarray:
    """(zeros, poles, gain) to ``[n_sections, 6]`` second-order
    sections for :func:`sosfilt`.  Same transfer function as scipy's
    ``zpk2sos`` up to section pairing/ordering (this module pairs
    conjugates simply; scipy's 'nearest' pairing optimizes fixed-point
    scaling, which float execution does not need — the frequency-
    response tests pin the equivalence)."""
    return _zpk_to_sos(np.asarray(z, complex), np.asarray(p, complex),
                       float(k))


def tf2sos(b, a) -> np.ndarray:
    """``(b, a)`` to second-order sections (via zpk)."""
    return zpk2sos(*tf2zpk(b, a))


def sos2tf(sos):
    """Second-order sections to a single ``(b, a)`` pair (scipy's
    ``sos2tf``): polynomial products of the section numerators and
    denominators."""
    sos = _check_sos(sos)
    b = np.array([1.0])
    a = np.array([1.0])
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    return b, a


def group_delay(system, n_points: int = 512):
    """Group delay ``-d(phase)/d(omega)`` of a digital filter in
    samples (scipy's ``group_delay``): ``system`` is a ``(b, a)``
    pair.  Returns ``(w, gd)`` on the same ``linspace(0, 1, n,
    endpoint=False)`` Nyquist-fraction axis as
    :func:`sos_frequency_response` (also scipy's default grid scaled
    by pi), so the two overlay point-for-point.

    Uses the Fourier-differentiation identity on ``c = b * reversed(a)``:
    gd = Re[(sum k c_k z^-k)/(sum c_k z^-k)] - (len(a) - 1), which
    avoids numerical phase unwrapping entirely.  At frequencies where
    the response is singular (a zero ON the unit circle at a grid
    point) the group delay is undefined — set to 0 with a warning,
    matching scipy.
    """
    b, a = system
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    c = np.convolve(b, a[::-1])
    cr = c * np.arange(len(c))
    w = np.linspace(0.0, 1.0, int(n_points), endpoint=False)
    zm = np.exp(-1j * np.pi * w)
    num = np.polyval(cr[::-1], zm)
    den = np.polyval(c[::-1], zm)
    singular = np.abs(den) < 10 * np.finfo(np.float64).eps * max(
        1.0, float(np.sum(np.abs(c))))
    if np.any(singular):
        import warnings

        warnings.warn("group_delay is singular at some frequencies "
                      "(response zero on the unit circle); setting "
                      "those points to 0", RuntimeWarning,
                      stacklevel=2)
    gd = np.real(num / np.where(singular, 1.0, den)) - (len(a) - 1)
    gd[singular] = 0.0
    return w, gd


# -- order estimation (scipy's buttord/cheb1ord/cheb2ord/ellipord):
#    the "how many poles do I need" front door of filter design.
#    Host-side float64; digital band edges as Nyquist fractions,
#    pre-warped through the bilinear transform exactly as the design
#    functions themselves do.


def _golden_min(f, lo: float, hi: float, iters: int = 120) -> float:
    """Golden-section minimum of a unimodal f on [lo, hi] (the
    bandstop passband-edge optimization; 120 iterations shrink the
    bracket below float64 resolution)."""
    inv_phi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - inv_phi * (b - a)
    d = a + inv_phi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - inv_phi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + inv_phi * (b - a)
            fd = f(d)
        if b - a < 1e-14 * (abs(a) + abs(b)):
            break
    return 0.5 * (a + b)


def _order_band_args(wp, ws, gpass, gstop):
    """Shared validation + pre-warp: returns ``(passb, stopb, ftype)``
    with scipy's type codes (1 low, 2 high, 3 bandstop, 4 bandpass)."""
    gpass, gstop = float(gpass), float(gstop)
    if not 0 < gpass < gstop:
        raise ValueError("need 0 < gpass < gstop (dB)")
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if wp.shape != ws.shape or wp.ndim != 1 or len(wp) not in (1, 2):
        raise ValueError("wp and ws must both be scalars or both be "
                         "(low, high) pairs")
    if np.any(wp <= 0) or np.any(wp >= 1) or np.any(ws <= 0) \
            or np.any(ws >= 1):
        raise ValueError("band edges must be in (0, 1) (Nyquist = 1)")
    ftype = 2 * (len(wp) - 1) + 1
    if wp[0] >= ws[0]:
        ftype += 1
    if len(wp) == 2:
        # the bands must nest strictly, or the selectivity formulas
        # (and the bandstop edge optimization's bracket) are meaningless
        if ftype == 3 and not (wp[0] < ws[0] < ws[1] < wp[1]):
            raise ValueError(
                f"bandstop needs wp[0] < ws[0] < ws[1] < wp[1], got "
                f"wp={wp.tolist()}, ws={ws.tolist()}")
        if ftype == 4 and not (ws[0] < wp[0] < wp[1] < ws[1]):
            raise ValueError(
                f"bandpass needs ws[0] < wp[0] < wp[1] < ws[1], got "
                f"wp={wp.tolist()}, ws={ws.tolist()}")
    passb = np.tan(np.pi * wp / 2.0)
    stopb = np.tan(np.pi * ws / 2.0)
    return passb, stopb, ftype, gpass, gstop


def _selectivity(passb, stopb, ftype):
    """Lowpass-prototype selectivity for fixed band edges."""
    if ftype == 1:
        nat = stopb / passb
    elif ftype == 2:
        nat = passb / stopb
    elif ftype == 3:
        nat = (stopb * (passb[0] - passb[1])
               / (stopb ** 2 - passb[0] * passb[1]))
    else:
        nat = ((stopb ** 2 - passb[0] * passb[1])
               / (stopb * (passb[0] - passb[1])))
    return float(np.min(np.abs(nat)))


def _order_measure(nat, gpass, gstop, kind):
    """The (real-valued) minimum order meeting (gpass, gstop) at
    selectivity ``nat`` for the given family."""
    gs = 10.0 ** (0.1 * gstop) - 1.0
    gp = 10.0 ** (0.1 * gpass) - 1.0
    if kind == "butter":
        return math.log10(gs / gp) / (2.0 * math.log10(nat))
    if kind == "cheby":
        return math.acosh(math.sqrt(gs / gp)) / math.acosh(nat)
    # elliptic: the degree equation N = [K/K'](1/nat^2) / [K/K'](m1)
    m0 = 1.0 / (nat * nat)
    m1 = gp / gs
    return (_ellipk(m0) * _ellipkp(m1)) / (_ellipkp(m0) * _ellipk(m1))


def _nat_freq(passb, stopb, ftype, gpass, gstop, kind):
    """Selectivity with scipy's bandstop refinement: for bandstop the
    passband edges may be moved INWARD (toward the stopband) without
    violating the spec wherever that lowers the required order — scipy
    optimizes each edge separately, and so does this.

    KNOWN DIVERGENCE: scipy's fminbound stops at xatol=1e-5 while this
    golden section converges to float64 resolution, so on rare
    bandstop specs sitting exactly at a ceil() boundary the tighter
    optimum yields an order ONE LOWER than scipy's (the design still
    meets the dB spec — the estimate is simply sharper).  Fixed-edge
    band types are bit-identical to scipy."""
    if ftype == 3:
        passb = passb.copy()

        def obj(w, ind):
            p = passb.copy()
            p[ind] = w
            return _order_measure(_selectivity(p, stopb, 3), gpass,
                                  gstop, kind)

        passb[0] = _golden_min(lambda w: obj(w, 0), passb[0],
                               stopb[0] - 1e-12)
        passb[1] = _golden_min(lambda w: obj(w, 1), stopb[1] + 1e-12,
                               passb[1])
    return _selectivity(passb, stopb, ftype), passb


def _wn_out(WN):
    wn = np.arctan(np.atleast_1d(WN)) * 2.0 / np.pi
    return float(wn[0]) if len(wn) == 1 else wn


def buttord(wp, ws, gpass: float, gstop: float):
    """Minimum Butterworth order (scipy's ``buttord``): the smallest
    order losing at most ``gpass`` dB in the passband and at least
    ``gstop`` dB in the stopband, plus the natural frequency ``wn``
    that EXACTLY meets the passband spec — feed ``(ord, wn)`` straight
    into :func:`butterworth`."""
    passb, stopb, ftype, gpass, gstop = _order_band_args(wp, ws, gpass,
                                                         gstop)
    nat, passb = _nat_freq(passb, stopb, ftype, gpass, gstop, "butter")
    order = int(math.ceil(_order_measure(nat, gpass, gstop, "butter")))
    gp = 10.0 ** (0.1 * gpass) - 1.0
    w0 = gp ** (-1.0 / (2.0 * order)) if order > 0 else 1.0
    if ftype == 1:
        WN = w0 * passb
    elif ftype == 2:
        WN = passb / w0
    elif ftype == 3:
        d = math.sqrt((passb[1] - passb[0]) ** 2
                      + 4 * w0 ** 2 * passb[0] * passb[1])
        WN = np.sort(np.abs([(passb[1] - passb[0] + d) / (2 * w0),
                             (passb[1] - passb[0] - d) / (2 * w0)]))
    else:
        w0_pair = np.array([-w0, w0])
        WN = np.sort(np.abs(
            -w0_pair * (passb[1] - passb[0]) / 2.0
            + np.sqrt(w0_pair ** 2 / 4.0 * (passb[1] - passb[0]) ** 2
                      + passb[0] * passb[1])))
    return order, _wn_out(WN)


def cheb1ord(wp, ws, gpass: float, gstop: float):
    """Minimum Chebyshev-I order (scipy's ``cheb1ord``); ``wn`` is the
    (bandstop-refined) passband edge, ready for :func:`cheby1`."""
    passb, stopb, ftype, gpass, gstop = _order_band_args(wp, ws, gpass,
                                                         gstop)
    nat, passb = _nat_freq(passb, stopb, ftype, gpass, gstop, "cheby")
    order = int(math.ceil(_order_measure(nat, gpass, gstop, "cheby")))
    return order, _wn_out(passb)


def cheb2ord(wp, ws, gpass: float, gstop: float):
    """Minimum Chebyshev-II order (scipy's ``cheb2ord``); ``wn`` is
    moved to the frequency where the response first reaches -gpass, so
    :func:`cheby2` at ``(ord, wn)`` meets the passband spec exactly."""
    passb, stopb, ftype, gpass, gstop = _order_band_args(wp, ws, gpass,
                                                         gstop)
    nat, passb = _nat_freq(passb, stopb, ftype, gpass, gstop, "cheby")
    v = _order_measure(nat, gpass, gstop, "cheby")
    order = int(math.ceil(v))
    gs = 10.0 ** (0.1 * gstop) - 1.0
    gp = 10.0 ** (0.1 * gpass) - 1.0
    new_freq = 1.0 / math.cosh(math.acosh(math.sqrt(gs / gp)) / order)
    if ftype == 1:
        WN = passb / new_freq
    elif ftype == 2:
        WN = passb * new_freq
    elif ftype == 3:
        n0 = (new_freq / 2.0 * (passb[0] - passb[1])
              + math.sqrt(new_freq ** 2 * (passb[1] - passb[0]) ** 2
                          / 4.0 + passb[1] * passb[0]))
        WN = np.array([n0, passb[0] * passb[1] / n0])
    else:
        n0 = ((passb[0] - passb[1]) / (2.0 * new_freq)
              + math.sqrt((passb[1] - passb[0]) ** 2
                          / (4.0 * new_freq ** 2)
                          + passb[1] * passb[0]))
        WN = np.array([n0, passb[0] * passb[1] / n0])
    return order, _wn_out(WN)


def ellipord(wp, ws, gpass: float, gstop: float):
    """Minimum elliptic order (scipy's ``ellipord``) via the degree
    equation on the AGM elliptic integrals; ``wn`` is the passband
    edge, ready for :func:`ellip`."""
    passb, stopb, ftype, gpass, gstop = _order_band_args(wp, ws, gpass,
                                                         gstop)
    nat, passb = _nat_freq(passb, stopb, ftype, gpass, gstop, "ellip")
    order = int(math.ceil(_order_measure(nat, gpass, gstop, "ellip")))
    return order, _wn_out(passb)


def iirnotch(w0: float, Q: float) -> np.ndarray:
    """Narrow band-reject biquad (scipy's ``iirnotch``) as a 1-section
    SOS: unit gain everywhere except a -3 dB-bandwidth ``w0/Q`` null at
    ``w0`` (fraction of Nyquist) — the classic mains-hum remover."""
    return _notch_peak_sos(w0, Q, peak=False)


def iirpeak(w0: float, Q: float) -> np.ndarray:
    """Narrow band-pass biquad (scipy's ``iirpeak``) as a 1-section
    SOS: unit gain only in the -3 dB band ``w0/Q`` around ``w0``."""
    return _notch_peak_sos(w0, Q, peak=True)


def _check_sos(sos) -> np.ndarray:
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [n_sections, 6], got {sos.shape}")
    if not np.allclose(sos[:, 3], 1.0):
        raise ValueError("sos rows must be normalized (a0 == 1)")
    return sos


def sos_frequency_response(sos, n_points: int = 512):
    """Complex response H(e^{jw}) on ``n_points`` frequencies in
    [0, pi) — host-side float64 design diagnostic (scipy's ``sosfreqz``).
    Returns ``(w, h)`` with ``w`` normalized to Nyquist = 1."""
    sos = _check_sos(sos)
    w = np.linspace(0.0, 1.0, n_points, endpoint=False)
    zinv = np.exp(-1j * np.pi * w)
    h = np.ones_like(zinv)
    for b0, b1, b2, _, a1, a2 in sos:
        h *= ((b0 + b1 * zinv + b2 * zinv ** 2)
              / (1.0 + a1 * zinv + a2 * zinv ** 2))
    return w, h


def frequency_response(b, a, n_points: int = 512):
    """Complex response of a transfer function ``b(z)/a(z)`` (host-side
    float64; scipy's ``freqz``).  ``w`` normalized to Nyquist = 1."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    w = np.linspace(0.0, 1.0, n_points, endpoint=False)
    zinv = np.exp(-1j * np.pi * w)
    num = np.polyval(b[::-1], zinv)
    den = np.polyval(a[::-1], zinv)
    return w, num / den


def sosfilt_zi(sos) -> np.ndarray:
    """Steady-state section states for a unit step input
    (scipy's ``sosfilt_zi``, same direct-form-II-transposed ``(z1, z2)``
    convention): scale by the signal's edge value to start a filter
    "already settled" — used by :func:`sosfiltfilt`.

    DF2T recurrence: ``y[t] = b0 x[t] + z1[t-1]``,
    ``z1[t] = b1 x[t] - a1 y[t] + z2[t-1]``,
    ``z2[t] = b2 x[t] - a2 y[t]``.  For constant input the states solve
    in closed form; each cascaded section sees the previous section's DC
    output as its constant input.  Returns ``[n_sections, 2]``.
    """
    sos = _check_sos(sos)
    zi = np.zeros((len(sos), 2))
    scale = 1.0
    for i, (b0, b1, b2, _, a1, a2) in enumerate(sos):
        y_ss = scale * (b0 + b1 + b2) / (1.0 + a1 + a2)
        z2_ss = scale * b2 - a2 * y_ss
        z1_ss = scale * (b1 + b2) - (a1 + a2) * y_ss
        zi[i] = (z1_ss, z2_ss)
        scale = y_ss
    return zi


# ---------------------------------------------------------------------------
# runtime (doubling scan)
# ---------------------------------------------------------------------------

# the scan's float32 transition powers and the steady states, on the
# device, keyed by the coefficients, the level count and the device
_device_cache = ConstantCache(64)
obs.register_cache("iir_device_lru", _device_cache.info)


def _companion(a) -> np.ndarray:
    """Float64 companion matrix ``[p, p]`` (p = max(len(a) - 1, 1)) of
    a normalized denominator: the state ``s[t] = (y[t], ...,
    y[t-p+1])`` advances as ``s[t] = A s[t-1] + (u[t], 0, ...)``."""
    a = np.asarray(a, np.float64)
    p = max(len(a) - 1, 1)
    comp = np.zeros((p, p))
    comp[0, :len(a) - 1] = -a[1:]
    comp[1:, :-1] = np.eye(p - 1)
    return comp


def _doubling_powers(comp: np.ndarray, levels: int) -> np.ndarray:
    """``A^(2^j)`` for j < ``levels``, squared in float64 and rounded
    once to float32, ``[levels', p, p]``: the list stops at the first
    power that rounds to zero (its squares are zero too)."""
    out = []
    m = comp
    for _ in range(levels):
        m32 = m.astype(np.float32)
        if not m32.any():
            break
        out.append(m32)
        m = m @ m
    return np.asarray(out, np.float32).reshape(-1, *comp.shape)


def _device_powers(comp: np.ndarray, n: int, dev):
    """The powers a scan of ``n`` steps runs, on ``dev`` (copied there
    once per filter and level count), as the level loop reads them:
    per level, the p columns of ``A^(2^j)`` as ``[p, 1, 1]`` views."""
    levels = max(n - 1, 0).bit_length()
    key = ("powers", comp.tobytes(), comp.shape[0], levels,
           str(torch.device(dev)))

    def build():
        powers = torch.as_tensor(_doubling_powers(comp, levels),
                                 device=dev)
        return tuple(tuple(m[:, c, None, None] for c in range(m.shape[1]))
                     for m in powers)

    return _device_cache.get(key, build)


def _doubling_scan(s: torch.Tensor, powers) -> None:
    """In place, the inclusive scan of ``s[t] = A s[t-1] + d[t]`` over
    ``s[p, rows, n]`` (the drive ``d`` on entry, the states on exit).

    Level j adds ``A^(2^j) s[t - 2^j]`` to every ``s[t]``, from the
    previous level's values (the product is formed before the add), so
    after it ``s[t]`` sums the drive of the last 2^(j+1) steps.  Each
    level is p elementwise fp32 multiply-adds over ``[p, rows, n]``;
    ``powers`` holds the columns of :func:`_device_powers`.
    """
    n = s.shape[-1]
    rows = s.split(1)
    for j, cols in enumerate(powers):
        k = 1 << j
        term = cols[0] * rows[0][..., :n - k]
        for col, row in zip(cols[1:], rows[1:]):
            term.addcmul_(col, row[..., :n - k])
        s[..., k:].add_(term)


def _fir_drive(x: torch.Tensor, b, p: int) -> torch.Tensor:
    """The scan operand ``[p, rows, n]`` for ``x[rows, n]``: row 0 the
    FIR drive ``u[t] = sum_k b[k] x[t-k]`` (shifted adds, fp32), the
    other rows zero."""
    n = x.shape[-1]
    s = x.new_zeros((p,) + tuple(x.shape))
    torch.mul(x, float(b[0]), out=s[0])
    for k in range(1, min(len(b), n)):
        if b[k] != 0.0:
            s[0, :, k:].add_(x[:, :n - k], alpha=float(b[k]))
    return s


def _transition_powers(comp: np.ndarray, n: int, dev) -> torch.Tensor:
    """``A^(t+1)`` for t < n, float32 ``[n, p, p]`` on ``dev``:
    products of float64 powers on the host (doubling), rounded once."""
    out = np.empty((n,) + comp.shape)
    if n:
        out[0] = comp
    m = 1
    while m < n:
        step = min(m, n - m)
        # A^(i+1) A^m = A^(i+1+m)
        out[m:m + step] = out[:step] @ out[m - 1]
        m += step
    return torch.as_tensor(out.astype(np.float32), device=dev)


def _biquad_affine_scan(a1, a2, drive):
    """The scan of ``s[t] = A s[t-1] + d[t]`` for the biquad companion
    ``A = [[-a1, -a2], [1, 0]]`` over ``drive[..., n, 2]``.

    Returns ``(cum_a, states)`` as the JAX package's does: ``states``
    ``[..., n, 2]`` and the transition products ``cum_a[t] = A^(t+1)``
    (``[n, 2, 2]``, broadcastable over the batch), with which a caller
    applies an incoming state as ``states + cum_a @ s_in`` without a
    second pass.
    """
    comp = _companion([1.0, a1, a2])
    n = drive.shape[-2]
    s = drive.reshape(-1, n, 2).permute(2, 0, 1).contiguous()
    _doubling_scan(s, _device_powers(comp, n, s.device))
    states = s.permute(1, 2, 0).reshape(drive.shape)
    return _transition_powers(comp, n, drive.device), states


def _section_exit_state(b1, b2, a1, a2, x_sec, y_sec):
    """DF2T exit state of one section from its last 2 in/out samples:
    ``z2 = b2 x[-1] - a2 y[-1]``,
    ``z1 = b1 x[-1] - a1 y[-1] + b2 x[-2] - a2 y[-2]``
    (valid for n >= 2 regardless of the incoming state)."""
    z2 = b2 * x_sec[..., -1] - a2 * y_sec[..., -1]
    z1 = (b1 * x_sec[..., -1] - a1 * y_sec[..., -1]
          + b2 * x_sec[..., -2] - a2 * y_sec[..., -2])
    return torch.stack([z1, z2], dim=-1)


def _sos_scan(x, sos_rows, zi=None, want_zf=False, powers=None):
    """The cascade over ``x[rows, n]`` (float32): per section the FIR
    drive, the incoming state's corrections (``zi[rows, sections,
    2]``: z1 onto y[0], z2 onto y[1]), then the doubling scan.
    ``powers`` (one :func:`_device_powers` a section, for this ``n``)
    are the caller's own device copies; None reads the device LRU."""
    n = x.shape[-1]
    zf = []
    for i, row in enumerate(sos_rows):
        b0, b1, b2, _, a1, a2 = (float(v) for v in row)
        s = _fir_drive(x, (b0, b1, b2), 2)
        if zi is not None:
            for t in range(min(n, 2)):
                s[0, :, t].add_(zi[:, i, t])
        _doubling_scan(s, powers[i] if powers is not None
                       else _device_powers(_companion((1.0, a1, a2)), n,
                                           x.device))
        y = s[0]
        if want_zf:
            zf.append(_section_exit_state(b1, b2, a1, a2, x, y))
        x = y
    # a compact result: s[0] keeps the whole scan operand alive
    y = x.clone()
    if want_zf:
        return y, torch.stack(zf, dim=-2)
    return y


def _state_tensor(zi, like: torch.Tensor) -> torch.Tensor:
    """An incoming state as float32 on ``like``'s device."""
    if isinstance(zi, torch.Tensor):
        return zi.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.array(zi, np.float32), device=like.device)


def _sosfilt_torch(x, sos, zi=None, want_zf=False, powers=None):
    """:func:`sosfilt` on the float32 tensor ``x[..., n]``; ``zi``
    ``[..., n_sections, 2]`` broadcasts over the batch; ``powers`` as
    in :func:`_sos_scan`."""
    batch, n = tuple(x.shape[:-1]), x.shape[-1]
    rows = math.prod(batch)
    zi_rows = None
    if zi is not None:
        want = batch + (len(sos), 2)
        # the JAX package reads the first len(sos) section rows of zi
        # (extra rows are ignored) and raises ValueError where the
        # rest does not broadcast; torch would raise RuntimeError
        zi = _state_tensor(zi, x)[..., :len(sos), :]
        got = tuple(zi.shape)
        try:
            ok = np.broadcast_shapes(got, want) == want
        except ValueError:
            ok = False
        if not ok:
            raise ValueError(f"Incompatible shapes for broadcasting: "
                             f"{got} and requested shape {want}")
        zi_rows = torch.broadcast_to(zi, want).reshape(rows, len(sos), 2)
    out = _sos_scan(x.reshape(rows, n), sos, zi_rows, want_zf, powers)
    if want_zf:
        y, zf = out
        return y.reshape(batch + (n,)), zf.reshape(batch + (len(sos), 2))
    return out.reshape(batch + (n,))


def _sos_work(x, sos, *_, **__):
    """``work=`` of a cascade: nine operations a sample and section
    (the direct form's five multiplies and four adds), the signal read
    and written once, 4 bytes a coefficient."""
    n_sos = len(sos)
    return (9.0 * n_sos * x.numel(),
            8.0 * x.numel() + 24.0 * n_sos)


# the instrumented core of sosfilt and StreamingSosfilt, the JAX
# package's _sosfilt_xla (sos_stream_step runs the cascade bare, as
# the JAX package's does)
_sosfilt_xla = obs.instrumented_jit(_sosfilt_torch, op="sosfilt_xla",
                                    work=_sos_work)


def sosfilt(sos, x, zi=None, simd=None, return_zf=False):
    """Filter ``x[..., n]`` through a cascade of second-order sections.

    ``sos`` is ``[n_sections, 6]`` (``[b0 b1 b2 1 a1 a2]`` rows, e.g.
    from :func:`butterworth`).  ``zi`` optionally gives each section's
    incoming state ``[..., n_sections, 2]`` in scipy's direct-form-II-
    transposed ``(z1, z2)`` convention (see :func:`sosfilt_zi`).  Each
    section runs as an O(log n)-depth doubling scan of its 2x2
    companion recurrence — a parallel formulation of the serial
    textbook loop the oracle implements.

    With ``return_zf=True`` also returns the exit states
    ``[..., n_sections, 2]`` (same DF2T convention) — feed them as the
    next block's ``zi`` to stream block-by-block (needs ``n >= 2``;
    see :class:`StreamingSosfilt`).
    """
    sos = _check_sos(sos)
    if return_zf and np.shape(x)[-1] < 2:
        raise ValueError("return_zf needs at least 2 samples per block")
    if resolve_simd(simd, op="iir"):
        with obs.span("sosfilt.dispatch", sections=len(sos)):
            return _sosfilt_xla(as_f32(x), sos, zi, return_zf)
    if return_zf:
        y, zf = sosfilt_na(sos, x, zi=zi, return_zf=True)
        return y.astype(np.float32), zf.astype(np.float32)
    return sosfilt_na(sos, x, zi=zi).astype(np.float32)


def sosfilt_na(sos, x, zi=None, return_zf=False):
    """NumPy float64 oracle twin of :func:`sosfilt`: the sequential
    direct-form recurrence, one sample at a time."""
    sos = _check_sos(sos)
    x = np.asarray(x, np.float64)
    y = x.copy()
    zf = np.zeros(x.shape[:-1] + (len(sos), 2))
    for i, (b0, b1, b2, _, a1, a2) in enumerate(sos):
        xs = y
        ys = np.zeros_like(xs)
        # DF2T form, matching scipy's state convention exactly
        z1 = np.zeros(xs.shape[:-1])
        z2 = np.zeros(xs.shape[:-1])
        if zi is not None:
            z1 = z1 + zi[..., i, 0]
            z2 = z2 + zi[..., i, 1]
        for t in range(xs.shape[-1]):
            xt = xs[..., t]
            yt = b0 * xt + z1
            z1 = b1 * xt - a1 * yt + z2
            z2 = b2 * xt - a2 * yt
            ys[..., t] = yt
        zf[..., i, 0] = z1
        zf[..., i, 1] = z2
        y = ys
    if return_zf:
        return y, zf
    return y


def _stream_powers(sos, n: int, dev) -> list:
    """The doubling scan's powers of each section's companion matrix
    for ``n``-sample blocks on ``dev``: what :func:`sos_stream_step`
    reads; a caller that holds them (the pipeline's stage) passes them
    as ``powers``."""
    return [_device_powers(_companion((1.0, row[4], row[5])), int(n),
                           dev)
            for row in _check_sos(sos)]


def sos_stream_step(x, sos, zi, powers=None):
    """One-block SOS cascade step — the pipeline compiler's
    state-export hook.

    ``x[..., b]`` (``b >= 2``) runs through the doubling-scan cascade
    with incoming DF2T state ``zi[..., n_sections, 2]``; returns
    ``(y, zf)`` with ``zf`` the exit states in the same convention —
    thread them into the next block's call and the concatenated outputs
    equal the one-shot cascade to f32 round-off.  ``sos`` is a host
    array; ``x`` and ``zi`` may be tensors on the card; ``powers`` as
    returned by :func:`_stream_powers` (None reads the device LRU).
    """
    sos = _check_sos(sos)
    return _sosfilt_torch(as_f32(x), sos, zi, want_zf=True,
                          powers=powers)


def sos_stream_step_na(x, sos, zi):
    """NumPy float64 oracle twin of :func:`sos_stream_step` (the
    pipeline's stage-by-stage degradation path): returns ``(y, zf)``."""
    return sosfilt_na(sos, x, zi=zi, return_zf=True)


class StreamingSosfilt:
    """Chunked streaming IIR with carried DF2T state.

    The IIR analog of :class:`~veles.simd_tpu_torch.ops.convolve.\
StreamingConvolution`: chunks arrive one at a time, each section's
    ``(z1, z2)`` state is carried between calls (on the device), and
    the concatenated outputs match the one-shot cascade to f32
    round-off (~1e-7 — the chunk boundary changes the scan's reduction
    order; no flush needed, an IIR has no lookahead)::

        st = StreamingSosfilt(butterworth(4, 0.25))
        ys = [st.process(c) for c in chunks]     # len(c) >= 2
        # torch.cat(ys, -1) == sosfilt(sos, x)

    Leading batch dims are allowed and fixed across calls.
    """

    def __init__(self, sos, zi=None, simd=None):
        self._sos = _check_sos(sos)
        self._simd = resolve_simd(simd, op="iir")
        self.reset(zi)

    def process(self, chunk):
        if np.shape(chunk)[-1] < 2:
            raise ValueError("chunks need at least 2 samples")
        if self._simd:
            y, zf = _sosfilt_xla(as_f32(chunk), self._sos, self._zi,
                                 want_zf=True)
        else:
            y, zf = sosfilt_na(self._sos, chunk, zi=self._zi,
                               return_zf=True)
            y = y.astype(np.float32)
        self._zi = zf
        return y

    def reset(self, zi=None):
        if isinstance(zi, torch.Tensor):
            self._zi = zi.to(torch.float32)
        else:
            self._zi = (np.zeros((len(self._sos), 2), np.float32)
                        if zi is None else np.asarray(zi, np.float32))


def _odd_ext(x, padlen: int):
    """Odd extension at both ends (scipy's filtfilt default padding),
    NumPy or torch."""
    if padlen == 0:
        return x
    n = x.shape[-1]
    if isinstance(x, torch.Tensor):
        left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
        right = 2 * x[..., -1:] - x[..., n - padlen - 1:n - 1].flip(-1)
        return torch.cat([left, x, right], dim=-1)
    left = 2 * x[..., :1] - x[..., padlen:0:-1]
    right = 2 * x[..., -1:] - x[..., -2:-padlen - 2:-1]
    return np.concatenate([left, x, right], axis=-1)


def _filtfilt_padlen(sos, n: int, padlen) -> int:
    if padlen is None:
        # scipy.signal.sosfiltfilt's default edge-padding length
        ntaps = 2 * len(sos) + 1
        ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
        padlen = 3 * int(ntaps)
    padlen = int(padlen)
    if padlen < 0 or (padlen >= n and padlen > 0):
        raise ValueError(f"padlen {padlen} must be in [0, n-1] "
                         f"(signal length {n})")
    return padlen


def sosfiltfilt(sos, x, padlen=None, simd=None):
    """Zero-phase forward-backward filtering (scipy's ``sosfiltfilt``).

    Odd-extends the signal by ``padlen`` (scipy's default formula,
    roughly ``6 * n_sections + 3``),
    runs the cascade forward with settled initial conditions
    (:func:`sosfilt_zi` scaled by the edge sample), reverses, repeats,
    and trims — doubling the magnitude response and cancelling the
    phase.
    """
    sos = _check_sos(sos)
    n = np.shape(x)[-1]
    padlen = _filtfilt_padlen(sos, n, padlen)
    if resolve_simd(simd, op="iir"):
        # outer span; the two sosfilt calls below nest their own
        with obs.span("sosfiltfilt.dispatch", sections=len(sos)):
            xt = as_f32(x)
            ext = _odd_ext(xt, padlen)
            zi = _device_cache.get(
                ("zi", sos.tobytes(), str(xt.device)),
                lambda: torch.as_tensor(sosfilt_zi(sos).astype(np.float32),
                                        device=xt.device))
            fwd = sosfilt(sos, ext, zi=zi * ext[..., :1, None], simd=True)
            bwd = sosfilt(sos, fwd.flip(-1),
                          zi=zi * fwd[..., -1:, None], simd=True)
            return bwd.flip(-1)[..., padlen:padlen + n]
    return sosfiltfilt_na(sos, x, padlen=padlen).astype(np.float32)


def filtfilt(b, a, x, padlen=None, simd=None):
    """Zero-phase forward-backward filtering in ``(b, a)`` form
    (scipy's ``filtfilt`` with its ``method='pad'`` default): routed
    through :func:`tf2sos` + :func:`sosfiltfilt` with scipy's
    ``3 * max(len(a), len(b))`` default padding — the same settled-
    state odd-extension construction, so results match scipy to float
    tolerance (the section pairing only reorders rounding).
    """
    b_arr = np.atleast_1d(np.asarray(b, np.float64))
    a_arr = np.atleast_1d(np.asarray(a, np.float64))
    if padlen is None:
        padlen = 3 * max(len(a_arr), len(b_arr))
    return sosfiltfilt(tf2sos(b_arr, a_arr), x, padlen=padlen,
                       simd=simd)


def sosfiltfilt_na(sos, x, padlen=None):
    """NumPy float64 oracle twin of :func:`sosfiltfilt`."""
    sos = _check_sos(sos)
    zi = sosfilt_zi(sos)
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    padlen = _filtfilt_padlen(sos, n, padlen)
    ext = _odd_ext(x, padlen)
    fwd = sosfilt_na(sos, ext, zi=zi * ext[..., :1, None])
    bwd = sosfilt_na(sos, fwd[..., ::-1], zi=zi * fwd[..., -1:, None])
    out = bwd[..., ::-1]
    return out[..., padlen:padlen + n]


# ---------------------------------------------------------------------------
# general transfer functions (companion-matrix scan)
# ---------------------------------------------------------------------------

_LFILTER_MAX_ORDER = 32  # p^2 multiply-adds a sample and level beyond


def _normalize_ba(b, a):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    return b / a[0], a / a[0]


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state DF2T state for a unit step input (scipy's
    ``lfilter_zi``): scale by the signal's edge value to start
    ``lfilter`` "already settled".  Host-side float64 closed form —
    the transposed-direct-form state recurrence at steady state
    ``z = A z + B`` solved as ``(I - A) z = B``, exactly scipy's
    companion-matrix construction.
    """
    b, a = _normalize_ba(b, a)
    n = max(len(a), len(b))
    a = np.concatenate([a, np.zeros(n - len(a))])
    b = np.concatenate([b, np.zeros(n - len(b))])
    if n == 1:
        return np.zeros(0)
    # DF2T state update for constant input x=1, output y:
    #   z_i = b_{i+1} - a_{i+1} y + z_{i+1}   (z_n = 0)
    # with steady y = sum(b)/sum(a); solve directly by back-substitution
    if a.sum() == 0.0:
        raise ValueError(
            "filter has a pole at z=1 (sum(a) == 0): no steady state "
            "exists for lfilter_zi (scipy raises LinAlgError here)")
    y = b.sum() / a.sum()
    zi = np.zeros(n - 1)
    acc = 0.0
    for i in range(n - 2, -1, -1):
        acc += b[i + 1] - a[i + 1] * y
        zi[i] = acc
    return zi


def _lfilter_torch(x, b, a):
    """:func:`lfilter` on the float32 tensor ``x[..., n]`` with the
    normalized float64 ``b``, ``a``: the FIR drive, then the doubling
    scan of the order-p companion recurrence (p = 1 with a zero
    companion for a pure FIR, which runs no level)."""
    batch, n = tuple(x.shape[:-1]), x.shape[-1]
    if not len(b):
        # an empty numerator drives nothing: zeros, as the JAX
        # package's routes and lfilter_na give
        return torch.zeros_like(x)
    x2 = x.reshape(math.prod(batch), n)
    comp = _companion(a)
    s = _fir_drive(x2, b, comp.shape[0])
    _doubling_scan(s, _device_powers(comp, n, x.device))
    y = s[0] if comp.shape[0] == 1 else s[0].clone()
    return y.reshape(batch + (n,))


# the instrumented core of lfilter, the JAX package's _lfilter_xla: a
# multiply and an add a numerator tap and a denominator lag each sample
_lfilter_xla = obs.instrumented_jit(
    _lfilter_torch, op="lfilter_xla",
    work=lambda x, b, a: (2.0 * (len(b) + len(a) - 1) * x.numel(),
                          8.0 * x.numel() + 4.0 * (len(b) + len(a))))


def lfilter(b, a, x, simd=None):
    """Direct-form transfer-function filter ``y = (b/a) * x``
    (scipy's ``lfilter``), order ≤ {max_order}.

    The denominator recurrence runs as a companion-matrix doubling
    scan (p multiply-adds a sample and level, O(log n) depth).  For
    high orders prefer :func:`sosfilt` — cascaded biquads are both
    better conditioned and cheaper.
    """
    b, a = _normalize_ba(b, a)
    p = len(a) - 1
    if p > _LFILTER_MAX_ORDER:
        raise ValueError(
            f"denominator order {p} > {_LFILTER_MAX_ORDER}: use sosfilt "
            "(cascaded second-order sections) for high-order filters")
    if resolve_simd(simd, op="iir"):
        with obs.span("lfilter.dispatch", order=p):
            return _lfilter_xla(as_f32(x), b, a)
    return lfilter_na(b, a, x).astype(np.float32)


if lfilter.__doc__:  # stripped under python -OO
    lfilter.__doc__ = lfilter.__doc__.format(max_order=_LFILTER_MAX_ORDER)


def lfilter_na(b, a, x):
    """NumPy float64 oracle twin of :func:`lfilter` (sequential)."""
    b, a = _normalize_ba(b, a)
    x = np.asarray(x, np.float64)
    y = np.zeros_like(x)
    for t in range(x.shape[-1]):
        acc = np.zeros(x.shape[:-1])
        for k_tap, bk in enumerate(b):
            if t - k_tap >= 0:
                acc = acc + bk * x[..., t - k_tap]
        for k_tap, ak in enumerate(a[1:], start=1):
            if t - k_tap >= 0:
                acc = acc - ak * y[..., t - k_tap]
        y[..., t] = acc
    return y
