#!/usr/bin/env python
"""Generate the port's wavelet coefficient table — the twin of
``tools/gen_wavelet_tables.py`` over
``veles.simd_tpu_torch.ops.wavelet_coeffs``.

Derives each supported (family, order) filter from its mathematical
definition (Daubechies and symlets by spectral factorization in
mpmath, coiflets by solving their moment system) and asserts that it
sums to the family's normalization and is orthogonal to working
precision.  Where the reference's published tables are given
(``--reference DIR``, a checkout holding ``src/symlets.c`` and
``src/coiflets.c``), the published rows are stored, each held to the
derivation within :func:`published_drift_bound` (the published
table's own generation error).  Without them, each derived row is
held to the COMMITTED row of the port's table (``_wavelet_tables.npz``)
within the same bound, and the committed row is kept, so a
regeneration leaves the committed file unchanged; a derived row
outside the bound fails the run, naming its key.  ``--derived``
stores the derived rows instead (still held to the bound): what
``chip_smoke.py``'s ``devtools`` phase runs through the kernels beside
the committed ones.

The table is written only where its content changed (``np.savez``
stamps each member with the time, so a rewrite of equal rows would
change the file's bytes).  ``--orders`` limits the run to some keys
(``daub8,sym8,coif6``) or families (``coif``); the other rows of the
output come from the committed table.

    python tools/gen_wavelet_tables_torch.py [--orders daub8,sym8]
        [--out PATH] [--derived] [--reference DIR]

A whole regeneration takes minutes (the symlets' root selections and
the coiflet solves); the sampled orders take seconds.
"""

import argparse
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from veles.simd_tpu_torch.ops import wavelet_coeffs as wc  # noqa: E402

# |published - exact_rebuild| upper bounds, measured per order band: the
# published table's own double-precision generation error.  The
# Daubechies rows were never published in another precision: the
# committed rows are this derivation's, reproduced to round-off.
_PUBLISHED_DRIFT = {
    "daub": [(76, 1e-12)],
    "sym": [(50, 1e-9), (62, 2e-8), (72, 5e-7), (74, 8e-6), (76, 5e-5)],
    "coif": [(18, 1e-10), (24, 5e-8), (30, 2e-5)],
}
# published-table steps: row i holds order step * (i + 1)
_PUBLISHED_FILES = {"sym": ("symlets.c", "kSymletsD", 2),
                    "coif": ("coiflets.c", "kCoifletsD", 6)}


def published_drift_bound(order: int, family: str = "sym") -> float:
    for max_order, bound in _PUBLISHED_DRIFT[family]:
        if order <= max_order:
            return bound
    raise ValueError((family, order))


def parse_reference_table(reference_root: str, filename: str,
                          symbol: str, order_step: int) -> list:
    """Rows of a kXD coefficient table, trailing zeros dropped."""
    path = os.path.join(reference_root, "src", filename)
    with open(path) as f:
        src = f.read()
    body = src[src.index(symbol):]
    body = body[:body.index("};\n")]
    rows = re.findall(r"\{([^{}]*)\}", body)
    out = []
    for i, row in enumerate(rows):
        vals = np.array([float(v) for v in re.findall(r"[-+0-9.eE]+", row)])
        order = order_step * (i + 1)
        if len(vals) != order:
            raise ValueError(f"row {i}: {len(vals)} taps, expected {order}")
        out.append(vals)
    return out


def select_keys(spec: str | None) -> list:
    """The ``(family, order)`` pairs a ``--orders`` spec names, in table
    order: comma-separated keys (``sym8``) or families (``coif``)."""
    every = [(t.value, o) for t in wc.WaveletType
             for o in wc.supported_orders(t)]
    if not spec:
        return every
    want = []
    for item in (s.strip() for s in spec.split(",") if s.strip()):
        m = re.fullmatch(r"([a-z]+)(\d*)", item)
        if m is None or m.group(1) not in {f for f, _ in every}:
            raise SystemExit(f"unknown order {item!r}")
        fam, order = m.group(1), m.group(2)
        picked = [(f, o) for f, o in every
                  if f == fam and (not order or o == int(order))]
        if not picked:
            raise SystemExit(f"unsupported order {item!r}")
        want += [k for k in picked if k not in want]
    return [k for k in every if k in want]


def derive(family: str, order: int) -> np.ndarray:
    """The derived filter in the table's normalization (daub Σ = √2,
    sym/coif Σ = 1), generated from scratch (the npz cache bypassed)."""
    if family == "daub":
        return wc._gen_daubechies(order)
    if family == "sym":
        return wc._gen_symlet(order) / np.sqrt(2)
    return wc._gen_coiflet(order) / np.sqrt(2)


def orth_err(f: np.ndarray, target: float) -> float:
    return max(abs(np.dot(f[: len(f) - 2 * k], f[2 * k:]) * 2
                   / target ** 2 - (1.0 if k == 0 else 0.0))
               for k in range(len(f) // 2))


def load_table(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def tables_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(a[k], b[k]) for k in a)


class DriftError(AssertionError):
    """A derived row outside its drift bound of the committed or
    published row."""


def regenerate(keys, committed: dict, published=None, derived=False,
               log=print) -> dict:
    """The regenerated rows of ``keys``: ``{key: row}``.  Raises
    :class:`DriftError` naming the first key whose derived row lies
    outside its bound."""
    out = {}
    for family, order in keys:
        t0 = time.time()
        key = f"{family}{order}"
        h = derive(family, order)
        target = np.sqrt(2) if family == "daub" else 1.0
        # the derived filter must be exact to working precision
        assert abs(h.sum() - target) < 1e-10, key
        assert orth_err(h, target) < 1e-9, key
        bound = published_drift_bound(order, family)
        if published is not None and family in published:
            step = _PUBLISHED_FILES[family][2]
            ref = published[family][order // step - 1]
            source = "published"
        else:
            ref = committed.get(key)
            source = "committed"
        note = f" {source}=absent"
        if ref is not None:
            drift = float(np.max(np.abs(h - ref))) \
                if ref.shape == h.shape else float("inf")
            if not drift < bound:
                raise DriftError(
                    f"{key}: derived row drifts {drift:.3e} from the "
                    f"{source} row, outside its bound {bound:.0e}")
            # the published/committed rows carry their own generation
            # error, bounded by the same envelope
            assert orth_err(ref, target) < 4 * bound + 1e-12, key
            note = f" {source}_drift={drift:.1e}<{bound:.0e}"
            if not derived:
                h = ref
        out[key] = np.asarray(h, np.float64)
        log(f"{key:8s} len={len(h):3d} sum_err={abs(h.sum() - target):.1e}"
            f" orth_err={orth_err(h, target):.1e}{note}"
            f"  ({time.time() - t0:.1f}s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=wc._TABLE_PATH,
                    help="table to write (default: the port's "
                    "_wavelet_tables.npz)")
    ap.add_argument("--orders", default=None,
                    help="keys or families to regenerate, comma-"
                    "separated (daub8,sym8,coif6; coif); default all")
    ap.add_argument("--derived", action="store_true",
                    help="store the derived rows, not the committed or "
                    "published ones")
    ap.add_argument("--reference", default=None,
                    help="reference checkout for the published rows "
                    "(none by default; skipped when its tables are "
                    "absent)")
    args = ap.parse_args(argv)

    have_ref = args.reference is not None and all(
        os.path.exists(os.path.join(args.reference, "src", f))
        for f, _s, _o in _PUBLISHED_FILES.values())
    published = {
        fam: parse_reference_table(args.reference, f, sym, step)
        for fam, (f, sym, step) in _PUBLISHED_FILES.items()
    } if have_ref else None
    if published is None:
        print("note: reference tables unavailable; holding the derived "
              "rows to the committed ones")
    committed = load_table(wc._TABLE_PATH)
    keys = select_keys(args.orders)
    try:
        rows = regenerate(keys, committed, published, args.derived)
    except DriftError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    table = dict(committed)
    table.update(rows)
    if tables_equal(table, load_table(args.out)):
        print(f"{len(rows)} rows regenerated; {args.out} unchanged")
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **table)
    print(f"{len(rows)} rows regenerated; wrote {len(table)} tables -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
