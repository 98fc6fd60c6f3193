"""Wavelet scaling-filter coefficients, generated numerically.

A copy of ``veles.simd_tpu.ops.wavelet_coeffs`` (it imports only NumPy,
but the port imports nothing of the JAX package), with its table cache
``_wavelet_tables.npz`` copied next to it.

The reference library ships ~6.4 kLoC of pre-generated coefficient tables
(``src/daubechies.c`` — Daubechies orders 2..76 even,
``src/symlets.c`` — Symlets 2..76, ``src/coiflets.c`` — Coiflets 6..30 step
6; provenance writeup ``src/daubechies.h:35-154``).  This module *derives*
the same families from their mathematical definitions instead of shipping
tables:

* **Daubechies** — classic spectral factorization: roots of
  ``P(y) = Σ_{k<p} C(p-1+k, k) y^k`` (the half-band autocorrelation
  polynomial), each mapped to the z-domain via ``z² - (2-4y)z + 1 = 0``
  keeping the min-phase (|z|<1) root, filter rebuilt as
  ``c·(1+z)^p·Π(z - z_i)`` in high-precision arithmetic (mpmath), oriented
  front-loaded and normalized to **Σh = √2** — the reference's convention
  (``src/daubechies.c:36-37``: order-2 row is {√½, √½}).

* **Symlets** — same factorization, but each root *orbit* (a complex
  conjugate pair or a real root) may be replaced by its reciprocal; the
  combination minimizing the L2 deviation of the unwrapped phase from
  linear is selected by exhaustive vectorized search (≤2^19 combinations at
  order 76).  Mirror-image ties are broken to the reference's orientation:
  single-orbit orders keep the Daubechies orientation (reference symlet
  rows 2-3 *are* db2/db3 — ``src/symlets.c:39-43``), searched orders take
  the mirror with the energy peak at or right of center (verified against
  ``src/symlets.c`` rows 4, 5, 8, 10).  Normalized to **Σh = 1** — the
  reference's symlet convention (``src/symlets.c:36-37``: order-2 row is
  {0.5, 0.5}).  Fidelity note: this reproduces the reference's table
  bit-for-bit at orders 2-12, 16, 18, 26, 34 and 42; at the remaining
  orders the reference's unattributed table picks a *different*
  near-optimal root selection that no single tested criterion (L2/L∞
  detrended phase, fixed-delay deviation, time-domain asymmetry)
  reproduces consistently — ours is the argmin of the documented metric,
  and every emitted filter is verified orthonormal with p vanishing
  moments either way.

* **Coiflets** — length-6K filters solving the defining system
  (orthonormality; Σh = √2; scaling moments ``Σ (n-2K)^j h[n] = 0`` for
  j=1..2K-1; wavelet moments ``Σ (-1)^n n^j h[n] = 0`` for j=0..2K-1) by
  multi-start Levenberg-Marquardt; among the solution branches the
  *most symmetric* one is the published coiflet family (verified against
  ``src/coiflets.c:36-41``).  Normalized to **Σh = 1** like the reference.

Generated tables are cached in-process per (family, order) and persisted to
``_wavelet_tables.npz`` next to this file by ``tools/gen_wavelet_tables.py``
so imports stay fast; if the cache file is missing the coefficients are
derived on first use.
"""

from __future__ import annotations

import enum
import functools
import os

import numpy as np

__all__ = [
    "WaveletType", "scaling_coefficients", "qmf_highpass",
    "validate_order", "supported_orders",
    "daubechies", "symlet", "coiflet",
]

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "_wavelet_tables.npz")


class WaveletType(enum.Enum):
    """``WaveletType`` at the reference's ``inc/simd/wavelet_types.h``."""

    DAUBECHIES = "daub"
    SYMLET = "sym"
    COIFLET = "coif"


def supported_orders(type: WaveletType) -> list[int]:
    """Reference-supported orders (``src/wavelet.c:167-185`` asserts)."""
    type = WaveletType(type)
    if type is WaveletType.COIFLET:
        return [6, 12, 18, 24, 30]
    return list(range(2, 77, 2))


def validate_order(type, order: int) -> bool:
    """``wavelet_validate_order`` (``inc/simd/wavelet.h:40-44``)."""
    try:
        return int(order) in supported_orders(WaveletType(type))
    except ValueError:
        return False


def qmf_highpass(lowpass: np.ndarray) -> np.ndarray:
    """Quadrature-mirror highpass from a lowpass: the reference's
    construction ``highpass[order-1-i] = (i odd ? +C[i] : -C[i])``
    (``src/wavelet.c:187-209``)."""
    order = len(lowpass)
    hp = np.empty_like(lowpass)
    i = np.arange(order)
    signs = np.where(i % 2 == 1, 1.0, -1.0)
    hp[order - 1 - i] = signs * lowpass
    return hp


# --------------------------------------------------------------------------
# Daubechies / Symlet spectral factorization
# --------------------------------------------------------------------------

def _mp():
    import mpmath

    return mpmath


def _daubechies_zroots(p: int):
    """Roots of the autocorrelation polynomial mapped to min-phase z-roots.

    Returns a list of (y_root, z_inside) pairs, |z_inside| < 1.
    """
    mp = _mp()
    mp.mp.dps = 40 + 3 * p
    if p == 1:
        return []
    coeffs = [mp.binomial(p - 1 + k, k) for k in range(p)]
    ys = mp.polyroots(list(reversed(coeffs)), maxsteps=400, extraprec=300)
    out = []
    for y in ys:
        b = 2 - 4 * y
        disc = mp.sqrt(b * b - 4)
        z1 = (b + disc) / 2
        z2 = (b - disc) / 2
        out.append((y, z1 if abs(z1) < 1 else z2))
    return out


def _build_from_roots(p: int, zroots) -> np.ndarray:
    """Polynomial c·(1+z)^p·Π(z−z_i), real part, scaled to Σ = √2."""
    mp = _mp()
    poly = [mp.mpf(1)]
    for _ in range(p):
        poly = [a + b for a, b in zip(poly + [mp.mpf(0)], [mp.mpf(0)] + poly)]
    for z in zroots:
        nxt = [mp.mpc(0)] * (len(poly) + 1)
        for i, c in enumerate(poly):
            nxt[i] += c * (-z)
            nxt[i + 1] += c
        poly = nxt
    taps = [mp.re(c) for c in poly]
    s = sum(taps)
    root2 = mp.sqrt(2)
    return np.array([float(t * root2 / s) for t in taps], np.float64)


def _gen_daubechies(order: int) -> np.ndarray:
    p = order // 2
    zr = _daubechies_zroots(p)
    # reversal orients the filter front-loaded (energy at low indices),
    # matching src/daubechies.c rows
    return _build_from_roots(p, [z for (_, z) in zr])[::-1]


def _root_orbits(zr):
    """Group (y, z) pairs into orbits: [z] for real y, [z, z̄] for a
    complex-conjugate pair of y-roots."""
    mp = _mp()
    used = [False] * len(zr)
    orbits = []
    for i, (y, z) in enumerate(zr):
        if used[i]:
            continue
        used[i] = True
        if abs(mp.im(y)) < mp.mpf(10) ** (-mp.mp.dps // 2):
            orbits.append([z])
        else:
            for j in range(i + 1, len(zr)):
                yj, zj = zr[j]
                if not used[j] and abs(yj - mp.conj(y)) < abs(y) * 1e-15 + \
                        mp.mpf(10) ** (-mp.mp.dps // 2):
                    used[j] = True
                    orbits.append([z, zj])
                    break
            else:
                raise RuntimeError("unpaired complex root")
    return orbits


# Root selections of the *published* symlet family (``src/symlets.c:38-39``),
# recovered from the reference table itself: for each root orbit of the
# Daubechies half-band polynomial (a real root or a conjugate pair), the bit
# says whether the published filter keeps the min-phase root (0) or its
# reciprocal (1); ``mirror`` flips the finished filter.  Recovery method
# (tools/check_wavelet_parity.py — runnable): evaluate the published row's
# z-transform at both candidate roots with scale-normalized residuals to
# classify each orbit, brute-force any ambiguous ones, accept on
# reconstruction match.
# Rebuilding from these selections in exact arithmetic reproduces the
# published rows to 5e-10 at orders ≤ 50; beyond that the published table's
# own double-precision generation error grows smoothly (1e-8 at 62 up to
# 2e-5 at 76 — the same magnitude as the rows' orthonormality residuals),
# so the published values, not the re-derivation, are the parity spec (the
# .npz ships them; this map documents *which* symlets they are).
_SYMLET_SELECTIONS = {
    4: (0, "1"), 6: (0, "1"), 8: (0, "10"), 10: (0, "01"), 12: (0, "010"),
    14: (0, "011"), 16: (0, "1010"), 18: (0, "1001"), 20: (0, "01001"),
    22: (0, "10011"), 24: (0, "010110"), 26: (0, "110100"),
    28: (0, "1100110"), 30: (0, "1101001"), 32: (0, "01101001"),
    34: (1, "01111000"), 36: (0, "010001110"), 38: (0, "110110100"),
    40: (0, "0101110001"), 42: (0, "1100001011"), 44: (0, "11001110010"),
    46: (0, "11001111000"), 48: (0, "011001001101"), 50: (0, "101100010101"),
    52: (0, "0100101110100"), 54: (0, "1010000010111"),
    56: (0, "01011100000111"), 58: (0, "11010001101010"),
    60: (0, "111001010000111"), 62: (0, "111000000010111"),
    64: (0, "1110100010000111"), 66: (0, "1101100010101100"),
    68: (0, "01101100100001011"), 70: (0, "11100001000101011"),
    72: (0, "110110001100001011"), 74: (0, "101001000110101101"),
    76: (0, "0110010001110101010"),
}


def _symlet_from_selection(order: int, mirror: int, bits: str) -> np.ndarray:
    """Build the symlet with an explicit per-orbit root selection."""
    mp = _mp()
    p = order // 2
    zr = _daubechies_zroots(p)
    orbits = _root_orbits(zr)
    if len(bits) != len(orbits):
        raise ValueError(
            f"order {order}: selection has {len(bits)} bits for "
            f"{len(orbits)} orbits")
    chosen = []
    for b, orb in zip(bits, orbits):
        for z in orb:
            chosen.append(1 / mp.conj(z) if b == "1" else z)
    h = _build_from_roots(p, chosen)
    return h[::-1] if mirror else h


def _gen_symlet(order: int) -> np.ndarray:
    p = order // 2
    if p == 1:
        return np.array([0.5, 0.5], np.float64) * np.sqrt(2)
    sel = _SYMLET_SELECTIONS.get(order)
    if sel is not None:
        return _symlet_from_selection(order, *sel)
    zr = _daubechies_zroots(p)
    orbits = _root_orbits(zr)
    nb = len(orbits)

    if nb == 1:
        # single orbit: both choices are mirror images; keep the Daubechies
        # orientation like the reference (src/symlets.c rows 2-3 = db2/db3)
        return _gen_daubechies(order)

    # vectorized exhaustive phase search over 2^nb orbit selections
    G = 64
    w = np.linspace(1e-3, np.pi - 1e-3, G)
    e = np.exp(-1j * w)
    phi_in, phi_out = [], []
    for orb in orbits:
        prod_in = np.ones(G, np.complex128)
        prod_out = np.ones(G, np.complex128)
        for z in orb:
            zc = complex(z)
            prod_in *= (e - zc)
            prod_out *= (e - 1.0 / np.conj(zc))
        phi_in.append(np.unwrap(np.angle(prod_in)))
        phi_out.append(np.unwrap(np.angle(prod_out)))
    phi_in = np.asarray(phi_in)
    delta = np.asarray(phi_out) - phi_in
    base = phi_in.sum(axis=0)
    design = np.stack([np.ones(G), w], axis=1)
    proj = np.eye(G) - design @ np.linalg.solve(design.T @ design, design.T)
    best_en, best_bits = np.inf, None
    for start in range(0, 1 << nb, 1 << 16):
        count = min(1 << 16, (1 << nb) - start)
        bits = ((np.arange(start, start + count)[:, None]
                 >> np.arange(nb)) & 1).astype(np.float64)
        resid = (base + bits @ delta) @ proj.T
        energy = np.einsum("ij,ij->i", resid, resid)
        i = int(np.argmin(energy))
        if energy[i] < best_en:
            best_en, best_bits = energy[i], bits[i].copy()

    mp = _mp()
    chosen = []
    for take_out, orb in zip(best_bits, orbits):
        for z in orb:
            chosen.append(1 / mp.conj(z) if take_out else z)
    h = _build_from_roots(p, chosen)
    # mirror-tie orientation: reference symlets put the energy peak at or
    # right of center (verified rows 4,5,8,10 of src/symlets.c)
    if int(np.argmax(np.abs(h))) < len(h) / 2:
        h = h[::-1]
    return h


# --------------------------------------------------------------------------
# Coiflets
# --------------------------------------------------------------------------

def _coiflet_residuals(K: int):
    """Residuals + analytic Jacobian of the coiflet defining system."""
    M = 6 * K
    n = np.arange(M, dtype=np.float64)
    alt = (-1.0) ** np.arange(M)
    # linear rows: Σh−√2, scaling moments, wavelet moments
    lin_rows = [np.ones(M)]
    lin_rows += [(n - 2.0 * K) ** j for j in range(1, 2 * K)]
    lin_rows += [alt * n ** j for j in range(2 * K)]
    lin = np.stack(lin_rows)
    lin_rhs = np.zeros(len(lin_rows))
    lin_rhs[0] = np.sqrt(2)
    # row-normalize: the high moment rows carry n^(2K-1) ~ 1e13 entries,
    # which wrecks LM conditioning (the coif5 outer taps are ~1e-7 and
    # unreachable otherwise)
    scale = np.linalg.norm(lin, axis=1, keepdims=True)
    lin = lin / scale
    lin_rhs = lin_rhs / scale[:, 0]

    def F(h):
        eqs = [np.dot(h[: M - 2 * k], h[2 * k:]) - (1.0 if k == 0 else 0.0)
               for k in range(3 * K)]
        return np.concatenate([np.array(eqs), lin @ h - lin_rhs])

    def J(h):
        rows = []
        for k in range(3 * K):
            g = np.zeros(M)
            g[: M - 2 * k] += h[2 * k:]
            g[2 * k:] += h[: M - 2 * k]
            rows.append(g)
        return np.concatenate([np.stack(rows), lin])

    return F, J


def _asymmetry(h: np.ndarray) -> float:
    """L2 mismatch between h and its reflection about the energy centroid."""
    n = np.arange(len(h))
    c = float(np.dot(n, h * h) / np.dot(h, h))
    score = 0.0
    for i in n:
        j = 2 * c - i
        jl = int(np.floor(j))
        t = j - jl
        v = 0.0
        if 0 <= jl < len(h):
            v += (1 - t) * h[jl]
        if 0 <= jl + 1 < len(h):
            v += t * h[jl + 1]
        score += (h[i] - v) ** 2
    return score


def _gen_coiflet(order: int) -> np.ndarray:
    """The order-``order`` coiflet (Σ = √2), a fresh array."""
    return _coiflet_solution(int(order)).copy()


@functools.lru_cache(maxsize=None)
def _coiflet_solution(order: int) -> np.ndarray:
    """The solve behind :func:`_gen_coiflet`, memoized: each order
    continues from the one below it, so a whole regeneration (orders 6
    to 30) solves every order once instead of once per order above
    it."""
    from scipy.optimize import least_squares

    K = order // 6
    M = 6 * K
    F, J = _coiflet_residuals(K)
    rng = np.random.RandomState(K)
    db = _gen_daubechies(6 * K)  # same length, orthonormal seed
    solutions = []
    seeds = []
    if K > 1:
        # continuation: the published coiflet family varies smoothly in K —
        # pad the (K-1) solution to length 6K in every front/back split
        prev = _coiflet_solution(order - 6)  # already Σ=√2
        seeds += [np.concatenate([np.zeros(f), prev, np.zeros(6 - f)])
                  for f in range(7)]
    seeds += [np.roll(db, s) for s in range(-2 * K, 2 * K + 1)]
    seeds += [db + rng.randn(M) * rng.uniform(0.05, 0.6) for _ in range(150)]
    for seed in seeds:
        try:
            res = least_squares(F, seed, jac=J, xtol=1e-15, ftol=1e-15,
                                gtol=1e-15, method="lm", max_nfev=2000)
        except Exception:
            continue
        x = res.x
        if np.abs(F(x)).max() < 1e-6:
            # Gauss-Newton polish: LM stalls ~1e-8 on the larger systems
            for _ in range(50):
                r = F(x)
                if np.abs(r).max() < 1e-12:
                    break
                x = x - np.linalg.lstsq(J(x), r, rcond=None)[0]
        if np.abs(F(x)).max() < 1e-10:
            if not any(np.allclose(x, s, atol=1e-6) for s in solutions):
                solutions.append(x)
    if not solutions:
        raise RuntimeError(f"coiflet order {order}: no solution found")
    solutions.sort(key=_asymmetry)
    return solutions[0]


# --------------------------------------------------------------------------
# public accessors with two-level cache (in-process + .npz)
# --------------------------------------------------------------------------

def _load_table_file():
    if os.path.exists(_TABLE_PATH):
        try:
            return dict(np.load(_TABLE_PATH))
        except Exception:
            return {}
    return {}


@functools.lru_cache(maxsize=None)
def _tables():
    return _load_table_file()


@functools.lru_cache(maxsize=None)
def scaling_coefficients(type, order: int) -> np.ndarray:
    """Lowpass (scaling) filter for (type, order), float64, in the
    reference's per-family normalization (daub Σ=√2; sym/coif Σ=1).

    ``order`` is the tap count, exactly as in the reference API
    (``wavelet_apply(type, order, ...)``).
    """
    type = WaveletType(type)
    order = int(order)
    if not validate_order(type, order):
        raise ValueError(
            f"unsupported {type.value} order {order}; supported: "
            f"{supported_orders(type)} (src/wavelet.c:167-185 contract)")
    key = f"{type.value}{order}"
    cached = _tables().get(key)
    if cached is not None:
        return cached
    if type is WaveletType.DAUBECHIES:
        h = _gen_daubechies(order)            # Σ = √2 already
    elif type is WaveletType.SYMLET:
        h = _gen_symlet(order) / np.sqrt(2)   # reference sym rows sum to 1
    else:
        h = _gen_coiflet(order) / np.sqrt(2)  # reference coif rows sum to 1
    return h


def daubechies(order: int) -> np.ndarray:
    return scaling_coefficients(WaveletType.DAUBECHIES, order)


def symlet(order: int) -> np.ndarray:
    return scaling_coefficients(WaveletType.SYMLET, order)


def coiflet(order: int) -> np.ndarray:
    return scaling_coefficients(WaveletType.COIFLET, order)
