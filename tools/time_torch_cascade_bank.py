#!/usr/bin/env python3
"""Take apart the time of the port's cascade-bank kernel (K3,
``csrc/cascade_bank.cu``) on one CUDA card.

    python3 tools/time_torch_cascade_bank.py [--repo DIR] [--label NAME]

Imports ``veles.simd_tpu_torch`` from the checkout at DIR (default: the
one holding this script), so two checkouts can be timed on one card in
one call: unpack the other commit (``git archive``) into a directory
that ``.gitignore`` lists and run the script once for each, in turns.
It knows both forms of the kernel: the first one (per-slot loop over
phases deinterleaved into shared memory) and the frame form (dense
per-frame tap table, read from registers).

Builds copies of the checkout's kernels with one part of K3's work
switched off (``no_staging``: no input copies, the kernel computes on
whatever shared memory holds; ``no_compute``: no multiply-adds;
``no_stores``: no output writes) into ``build/cascade_bank/``, all
``nvcc`` runs started together, and times each with the intact build
at the main path's shape, 512 x 4096 daub8 at 3 levels: the contract
form on the periodically extended input and, where the checkout has
it, the periodic form that reads the wrap and writes natural order.
The intact build also times three other plans at 512 x 4096 (daub4 at
4 levels, sym16 at 3, coif12 at 2) and ``wavelet_transform`` at the
main shape, with its device breakdown: the fused cascade, where the
checkout's default takes it there.  Prints the card's name and power
limit, then one JSON line per build, device time per call from
``torch.profiler``.  Exits non-zero without a card.  The
copies are diagnostics only; their outputs are not checked.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROWS, N = 512, 4096
MAIN = ("daub", 8, 3)
OTHERS = (("daub", 4, 4), ("sym", 16, 3), ("coif", 12, 2))
SEED = 20261016
# the texts each build replaces in cascade_bank.cu, by form; every text
# must be found
FORMS = {
    "slots": {
        "no_staging": ((
            "for (int m = tid; m < span; m += CB_THREADS) {",
            "for (int m = tid; m < 0; m += CB_THREADS) {"),),
        "no_compute": ((
            "for (int s = s_start[c]; s < end; ++s) {",
            "for (int s = s_start[c]; s < 0; ++s) {"),),
        "no_stores": ((
            "if (i < n_out) oc[i] = acc[r];",
            "if (i < n_out && acc[r] == 1234.5f) oc[i] = acc[r];"),),
    },
    "frames": {
        "no_staging": ((
            "for (int k = lane; k < chunks; k += 32) {",
            "for (int k = lane; k < 0; k += 32) {"),
            ("for (int k = lane; k < span; k += 32) {",
             "for (int k = lane; k < 0; k += 32) {")),
        "no_compute": ((
            "if ((m >> c) & 1u) {", "if (false) {"),),
        "no_stores": ((
            "    if (valid <= 0) return;",
            "    if (valid <= 0 || v[0] != 1234.5f) return;"),
            ("    if (n_valid <= 0) return;",
             "    if (n_valid <= 0 || buf[0] != 1234.5f) return;")),
    },
}


def form_of(source: str) -> str:
    return "slots" if "cb_kernel(" in source else "frames"


def build_all(ck, csrc, out):
    """Write each build's sources under ``out``, compile every object
    with one ``nvcc`` each, all started together (the sources K3 does
    not touch once), link one library per build where the checkout's
    loader looks for it, and return ``{build: source dir}``."""
    text = open(os.path.join(csrc, "cascade_bank.cu")).read()
    form = form_of(text)
    edits = FORMS[form]
    dirs = {}
    for name in ("intact",) + tuple(edits):
        d = os.path.join(out, name, "csrc")
        if os.path.isdir(d):
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        edited = text
        for old, new in edits.get(name, ()):
            if old not in edited:
                raise RuntimeError(f"{name}: {old!r} not in the {form} "
                                   "form's cascade_bank.cu")
            edited = edited.replace(old, new)
        with open(os.path.join(d, "cascade_bank.cu"), "w") as f:
            f.write(edited)
        dirs[name] = d
    nvcc = ck._nvcc()
    flags = list(ck._NVCC_FLAGS)
    procs, objs = [], {}
    common = os.path.join(out, "common")
    os.makedirs(common, exist_ok=True)
    for src in ck._SOURCES:
        for name, d in dirs.items():
            if src != "cascade_bank.cu" and name != "intact":
                continue
            where = common if src != "cascade_bank.cu" else d
            obj = os.path.join(where, src + ".o")
            objs.setdefault(name, {})[src] = obj
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-c", os.path.join(d, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    # ptxas -v on the intact K3: its kernels' registers and spills
    ptxas = [ln.strip() for ln in logs[
        [p.args[-1] for p in procs].index(objs["intact"]["cascade_bank.cu"])
    ].splitlines() if "registers" in ln or "spill" in ln]
    from pathlib import Path

    for name, d in dirs.items():
        ck._CSRC = Path(d)
        ck._BUILD_ROOT = Path(out) / name / "lib"
        lib_dir = ck._build_dir()
        lib_dir.mkdir(parents=True, exist_ok=True)
        objects = [objs[name].get(s, objs["intact"][s])
                   for s in ck._SOURCES]
        subprocess.run([nvcc, "-shared", "-o",
                        str(lib_dir / ck._LIB_NAME), *objects], check=True)
        (lib_dir / "build.log").write_text("\n".join(logs))
    return form, dirs, ptxas


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=here,
                    help="checkout whose veles.simd_tpu_torch is timed")
    ap.add_argument("--label", default=None,
                    help="name printed with each line (default: --repo)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_torch_cascade_bank: no CUDA card", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from pathlib import Path

    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    label = args.label or args.repo
    print(f"card: {smi_line()} | checkout {label} ({ck.__file__})")
    set_config(device="cuda")
    out = os.path.join(here, "build", "cascade_bank",
                       os.path.basename(repo.rstrip("/")) or "repo")
    form, dirs, ptxas = build_all(ck, str(ck._CSRC), out)
    periodic = getattr(ck, "cascade_bank_periodic_cuda", None)
    P = wv.ExtensionType.PERIODIC
    rng = np.random.RandomState(SEED)
    x = torch.as_tensor(rng.randn(ROWS, N).astype(np.float32),
                        device="cuda")

    def calls(type, order, levels):
        # (plans, taps, [channels,] reach): the first form's also
        # names each channel
        plan = wv._cascade_plan_for(wv.WaveletType(type), order, levels)
        plans, taps, reach = plan[0], plan[1], plan[-1]
        ns = 1 << levels
        x_ext = wv._extend(x, P, reach + ns).contiguous()
        out = {"contract": lambda: ck.cascade_bank_cuda(
            x_ext, taps, plans, ns, N // ns)}
        if periodic is not None:
            out["periodic"] = lambda: periodic(x, taps, plans, levels)
        return out

    def fused():
        return wv.wavelet_transform(*MAIN[:2], P, x, MAIN[2])

    for name, d in dirs.items():
        ck._CSRC = Path(d)
        ck._BUILD_ROOT = Path(out) / name / "lib"
        ck._lib = None
        ck.load_library()
        row = {"checkout": label, "form": form, "build": name,
               "shape": f"{ROWS}x{N} {MAIN[0]}{MAIN[1]} L{MAIN[2]}"}
        for kind, fn in calls(*MAIN).items():
            row[f"{kind}_ms"] = bm.device_busy_ms(fn, calls=20)
        if name == "intact":
            row["ptxas"] = ptxas
            for type, order, levels in OTHERS:
                for kind, fn in calls(type, order, levels).items():
                    row[f"{type}{order} L{levels} {kind}_ms"] = \
                        bm.device_busy_ms(fn, calls=20)
            row["fused_wavelet_transform_busy_ms"] = bm.device_busy_ms(
                fused, calls=20)
            row["fused_breakdown"] = bm.device_breakdown(fused, calls=5)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
