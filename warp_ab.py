"""Time the line-crop warp kernel of this checkout against other
versions of its source on one NVIDIA GPU, in turns.

    python3 warp_ab.py OLD.cu [OTHER.cu ...]

For example, against the previous commit's kernel:

    mkdir -p build/ab && git show HEAD~1:pero_ocr_tpu_torch/csrc/warp_lines.cu \\
        > build/ab/parent.cu && python3 warp_ab.py build/ab/parent.cu

Each source is built like ``csrc/warp_lines.cu`` (the flags of
``utils/kernels.py``) into ``build/warp_ab/``, run at ``chip_smoke.py``'s
main-path shapes on the same inputs, held to the plain version (bit
equal, but for one validity-boundary column per line), and timed warm
and cold with ``chip_smoke.cuda_ms``: every source in the order given,
then in reverse (A B B A), so that drift shows.  A source whose C entry
predates the ``out_bf16``/``normalize`` arguments runs in float32 only.
An empty kernel on the same grid gives the launch floor that every
timing holds.  Prints the card's nvidia-smi line, then one JSON line per
source and mode.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from pero_ocr_tpu_torch.ops import warp as warp_ops
from pero_ocr_tpu_torch.utils import kernels

OUT_DIR = Path(__file__).resolve().parent / "build" / "warp_ab"
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(int gx, int gy, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
MODES = {"f32": (torch.float32, False), "bf16_normalized": (torch.bfloat16, True)}


def build(sources):
    """name -> loaded library, one nvcc per source, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT_DIR / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} exited {proc.returncode}:\n{log}")
        print(f"nvcc {name}: " + "; ".join(
            line.split(":", 1)[1].strip() for line in log.splitlines() if "Used" in line))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(paths) -> int:
    if not torch.cuda.is_available():
        print("warp_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "empty.cu").write_text(EMPTY_CU)
    sources = {"this": kernels.CSRC / "warp_lines.cu", "empty": OUT_DIR / "empty.cu"}
    sources.update({f"{i}_{Path(p).stem}": Path(p) for i, p in enumerate(paths)})
    libs = build(sources)

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    pages = torch.from_numpy(
        rng.integers(0, 256, (cs.PAGE_BATCH, cs.PAGE_H, cs.PAGE_W), dtype=np.uint8)
    ).to(dev)
    geo = [cs.line_mix(rng, cs.LINES_PER_PAGE, cs.PAGE_H, cs.PAGE_W)
           for _ in range(cs.PAGE_BATCH)]
    bl = torch.from_numpy(np.stack([g[0] for g in geo])).to(dev)
    hh = torch.from_numpy(np.stack([g[1] for g in geo])).to(dev)
    pb, h, w = pages.shape
    n, p = bl.shape[1], bl.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    tiles = -(-cs.BUCKET // 128)

    def launcher(name, dtype, normalize, out):
        fn = libs[name].warp_lines_u8
        legacy = "out_bf16" not in sources[name].read_text()
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (7 if legacy else 9) + [
            ctypes.c_void_p]
        if legacy and (dtype, normalize) != (torch.float32, False):
            return None
        tail = () if legacy else (int(dtype == torch.bfloat16), int(normalize))
        args = (pages.data_ptr(), bl.data_ptr(), hh.data_ptr(), out.data_ptr(),
                pb, h, w, n, p, cs.CROP_H, cs.BUCKET, *tail, stream)
        return lambda: fn(*args)

    empty = libs["empty"].launch_empty
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    print(json.dumps({"source": "empty kernel, grid of the warp", "ms_warm": cs.cuda_ms(
        lambda: empty(pb * n, tiles, 256, stream))}))

    names = [k for k in sources if k != "empty"]
    for mode, (dtype, normalize) in MODES.items():
        want = warp_ops.warp_lines_plain(pages, bl, hh, cs.CROP_H, cs.BUCKET, dtype, normalize)
        int_t = torch.int16 if dtype == torch.bfloat16 else torch.int32
        out = torch.empty_like(want)
        runs = {}
        for name in names:
            fn = launcher(name, dtype, normalize, out)
            if fn is None:
                continue
            out.zero_()
            if fn() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            bad = (out.view(int_t) != want.view(int_t)).any(dim=1).sum(dim=1)
            if int(bad.max()) > 1:
                raise AssertionError(f"{name} {mode} disagrees with the plain version")
            runs[name] = {"warm": [], "cold": []}
        order = list(runs) + list(runs)[::-1]
        for name in order:
            fn = launcher(name, dtype, normalize, out)
            runs[name]["warm"].append(cs.cuda_ms(fn))
            runs[name]["cold"].append(cs.cuda_ms(fn, cold=True))
        for name, t in runs.items():
            print(json.dumps({"source": os.path.relpath(sources[name]), "mode": mode,
                              "ms_warm": t["warm"], "ms_cold": t["cold"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
