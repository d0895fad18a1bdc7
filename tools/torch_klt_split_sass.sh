#!/usr/bin/env bash
# Whether nvcc's --split-compile (ops/native.py's flags) changes the
# machine code of the tracking kernels: compiles vins_tpu_torch/csrc/klt.cu
# with and without it and compares each kernel's SASS (cuobjdump -sass,
# instruction addresses stripped). Prints how many kernels are identical,
# which differ, and the first lines of one difference (K2's runtime-window
# kernel where it differs). Needs the CUDA toolkit (nvcc, cuobjdump), no
# card. Run from the repo root: bash tools/torch_klt_split_sass.sh
set -e
CUDA=${CUDA_HOME:-/usr/local/cuda}
OUT=smoke_out/split_sass
mkdir -p "$OUT"
F="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC"
"$CUDA/bin/nvcc" $F -c -o "$OUT/A.o" vins_tpu_torch/csrc/klt.cu &
"$CUDA/bin/nvcc" $F --split-compile=0 -Xptxas --split-compile=0 -c \
  -o "$OUT/B.o" vins_tpu_torch/csrc/klt.cu &
wait
"$CUDA/bin/cuobjdump" -sass "$OUT/A.o" > "$OUT/A.sass"
"$CUDA/bin/cuobjdump" -sass "$OUT/B.o" > "$OUT/B.sass"
python3 - "$OUT" <<'PY'
import difflib
import re
import sys


def funcs(path):
    out, name, body = {}, None, []
    for line in open(path):
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = body
            name, body = m.group(1), []
        elif name:
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if line and not line.startswith("/*"):
                body.append(line)
    if name:
        out[name] = body
    return out


a = funcs(sys.argv[1] + "/A.sass")
b = funcs(sys.argv[1] + "/B.sass")
short = lambda n: n.split("klt_cu_")[-1][:60]
same = [n for n in a if a[n] == b.get(n)]
diff = [n for n in a if n in b and a[n] != b[n]]
print("kernels", len(a), len(b), "same names", set(a) == set(b))
print("identical SASS:", len(same), "different:", len(diff))
print("identical:", [short(n) for n in same])
for n in diff:
    print("  differs:", short(n), len(a[n]), "vs", len(b[n]), "lines")
pick = [n for n in diff if "patch_ncc_kernel_r" in n] or diff[:1]
if pick:
    d = list(difflib.unified_diff(a[pick[0]], b[pick[0]], lineterm="", n=0))
    print("diff of", short(pick[0]), len(d), "lines")
    print("\n".join(d[:20]))
PY
