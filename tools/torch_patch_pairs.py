"""K3's patch entry against another brief.cu, timed in alternating pairs
on one NVIDIA GPU.

    python3 tools/torch_patch_pairs.py --parent PATH [--wins 49,65]
        [--pairs 10]                                (from the repo root)

Builds three libraries with nvcc and the program's own flags, in
parallel, into smoke_out/ (git-ignored): the entry, from
vins_tpu_torch/csrc/brief.cu; the same source again, a copy; and the
brief.cu at PATH as it is (e.g. a parent commit's, unpacked with git
archive into a git-ignored directory). Prints the registers, spills and
shared memory that ptxas reports for each patches_kernel, and checks
each library against ops/brief_cuda.extract_patches_plain bit for bit on
chip_smoke.brief_inputs' blurred 640x480 frame at N = 512 keypoints
(border keypoints included). Then, at each window, it times `--pairs`
pairs of the entry and the parent and as many of the entry and the copy,
the order within a pair alternating from one pair to the next: device
ms as chip_smoke._device_ms (20 launches in a CUDA graph, one replay
timed with CUDA events). The copy's pairs read the spread of identical
code: the largest |copy / entry - 1| at that window. A pair goes to the
parent where parent / entry < 1 - spread, to the entry where it is over
1 + spread, else to neither. Prints one JSON line: per window the means,
each pair's parent / entry and copy / entry, the spread and the pairs
each side won; and the card. Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "smoke_out", "patch_pairs")
_VP = ctypes.c_void_p


def _build(sources: dict) -> tuple:
    """One library per source, nvcc in parallel; returns ({name: CDLL},
    {name: ptxas lines of patches_kernel})."""
    from vins_tpu_torch.ops import native
    os.makedirs(OUT, exist_ok=True)
    cmds, paths = [], {}
    for j, (name, path) in enumerate(sources.items()):
        paths[name] = os.path.join(OUT, f"libpatches{j}.so")
        cmds.append([native._nvcc(), *native.NVCC_FLAGS, "-shared", "-o",
                     paths[name], path])
    reports = native._run_all(cmds)
    libs, ptxas = {}, {}
    for (name, path), rep in zip(paths.items(), reports):
        lib = ctypes.CDLL(path)
        lib.vins_extract_patches.argtypes = [
            _VP, ctypes.c_int, ctypes.c_int, _VP, ctypes.c_int,
            ctypes.c_int, _VP, _VP]
        lib.vins_extract_patches.restype = ctypes.c_int
        if hasattr(lib, "vins_patches_init"):  # an opt-in of its own
            lib.vins_patches_init.restype = ctypes.c_int
            native.check(lib.vins_patches_init(), "vins_patches_init")
        libs[name] = lib
        lines = rep.splitlines()
        ptxas[name] = [f"{lines[i - 1].strip()}; {ln.strip()}"
                       for i, ln in enumerate(lines)
                       if "Used" in ln and i >= 3
                       and "patches_kernel" in " ".join(lines[i - 3:i])]
    return libs, ptxas


def _patches(lib, img, pts, win):
    import torch
    from vins_tpu_torch.ops import native
    out = torch.empty((pts.shape[0], win, win), dtype=torch.float32,
                      device=pts.device)
    native.check(lib.vins_extract_patches(
        img.data_ptr(), img.shape[0], img.shape[1], pts.data_ptr(),
        pts.shape[0], win, out.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream),
        "vins_extract_patches")
    return out


def _pair(first, second, k: int) -> tuple:
    """Device ms of first and second, in this order at even k, else in
    the other."""
    if k % 2:
        b = chip_smoke._device_ms(second)
        return chip_smoke._device_ms(first), b
    a = chip_smoke._device_ms(first)
    return a, chip_smoke._device_ms(second)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--wins", default="49,65")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch
    from vins_tpu_torch import default_config
    from vins_tpu_torch.ops import brief_cuda, native

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    entry = os.path.join(native.CSRC_DIR, "brief.cu")
    libs, ptxas = _build(dict(entry=entry, copy=entry,
                              parent=os.path.abspath(args.parent)))
    for name, lines in ptxas.items():
        print(f"{name}: {' | '.join(lines)}", flush=True)
    raw = chip_smoke.frame_pair(default_config(), dev)[-1]
    blurred, kp, _ = chip_smoke.brief_inputs(raw, chip_smoke.N_PATCHES, dev)
    result = {}
    for win in (int(w) for w in args.wins.split(",")):
        ref = brief_cuda.extract_patches_plain(blurred, kp, win)
        calls = {name: (lambda lib=lib: _patches(lib, blurred, kp, win))
                 for name, lib in libs.items()}
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            n_diff = int((got != ref).sum())
            if n_diff:
                sys.exit(f"{name} at {win}x{win}: {n_diff} of "
                         f"{got.numel()} values differ from the plain "
                         f"version")
        runs = {name: [] for name in ("entry", "parent", "entry'", "copy")}
        for k in range(args.pairs):
            for a, b in (("entry", "parent"), ("entry'", "copy")):
                ta, tb = _pair(calls[a.rstrip("'")], calls[b], k)
                runs[a].append(ta)
                runs[b].append(tb)
        parent = [p / e for p, e in zip(runs["parent"], runs["entry"])]
        copy = [c / e for c, e in zip(runs["copy"], runs["entry'"])]
        spread = max(abs(c - 1) for c in copy)
        result[win] = dict(
            mean_ms={n: sum(v) / len(v) for n, v in runs.items()},
            parent_over_entry=parent, copy_over_entry=copy, spread=spread,
            parent_won=sum(r < 1 - spread for r in parent),
            entry_won=sum(r > 1 + spread for r in parent))
        print(f"window {win}: entry {result[win]['mean_ms']['entry']:.5f} "
              f"ms, parent {result[win]['mean_ms']['parent']:.5f} ms; "
              f"spread {spread:.4f}; pairs won: parent "
              f"{result[win]['parent_won']}, entry "
              f"{result[win]['entry_won']} of {args.pairs}", flush=True)
    print(json.dumps(dict(windows=result, ptxas=ptxas,
                          card=chip_smoke._card_line())))


if __name__ == "__main__":
    main()
