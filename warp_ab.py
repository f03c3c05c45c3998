"""Time a warp kernel of this checkout against other versions of its
source on one NVIDIA GPU, in turns.

    python3 warp_ab.py OLD.cu [OTHER.cu ...]             # csrc/warp_lines.cu
    python3 warp_ab.py --fields OLD.cu [OTHER.cu ...]    # csrc/warp_fields.cu

For example, against the previous commit's kernels:

    mkdir -p build/ab && git show HEAD~1:pero_ocr_tpu_torch/csrc/warp_lines.cu \\
        > build/ab/parent.cu && python3 warp_ab.py build/ab/parent.cu
    git show HEAD~1:pero_ocr_tpu_torch/csrc/warp_fields.cu \\
        > build/ab/parent_fields.cu && python3 warp_ab.py --fields build/ab/parent_fields.cu

Each source is built with the flags of ``utils/kernels.py`` into
``build/warp_ab/``, held to the plain version on the same inputs and
timed warm and cold with ``chip_smoke.cuda_ms``: every variant in the
order given, then in reverse (A B B A), so that drift shows.  An empty
kernel on the same grid gives the launch floor that every timing holds.
Prints the card's nvidia-smi line, each build's ptxas lines, then one
JSON line per variant.

The line warp runs at ``chip_smoke.py``'s main-path shapes (bit equal,
but for one validity-boundary column per line); a source whose C entry
predates the ``out_bf16``/``normalize`` arguments runs in float32 only.

The field warp runs on a synthetic two-column BGR page
(``chip_smoke.synthetic_pages``) with its true lines' fields packed by
``LineCropper.pack_fields`` (LINE_HEIGHT 32, INTERP 2, LINE_SCALE 1.0),
uint8 store, bit equal, on the uint8 page and on the same page as
float32: each source with one launch a width bucket (as before the
packed buffer) and with one launch over the packed buffer.  The empty
kernel runs on this kernel's grid over the buffer and on the per-bucket
grids of a one-sample-a-thread design.
"""

from __future__ import annotations

import configparser
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from pero_ocr_tpu_torch.document.page_parser import LineCropper
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
            line.split(":")[-1].strip() for line in log.splitlines()
            if "Used" in line or "spill" in line))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(args) -> int:
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
    if args[:1] == ["--fields"]:
        return fields_main(args[1:])
    return lines_main(args)


def lines_main(paths) -> int:
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


def field_inputs():
    """A synthetic two-column page (BGR, on the card) and its true lines'
    fields as LineCropper packs them: (page, field buffer on the card,
    the buckets' (N, Hc, Wb) shapes)."""
    rng = np.random.default_rng(0)
    pages, lines = cs.synthetic_pages(rng, 1, cs.TWO_COLUMNS)
    config = configparser.ConfigParser()
    config.read_string("[LINE_CROPPER]\nLINE_HEIGHT = 32\nINTERP = 2\nLINE_SCALE = 1.0\n")
    cropper = LineCropper(config["LINE_CROPPER"], device="cuda")
    b_list, h_list = lines[0]
    fields = [cropper.crop_engine.get_crop_inputs(b, hh, 32) for b, hh in zip(b_list, h_list)]
    buffer, shapes, _, _ = cropper.pack_fields(fields)
    return (torch.from_numpy(pages[0]).cuda(), torch.from_numpy(buffer).cuda(), shapes)


def fields_main(paths) -> int:
    this = kernels.CSRC / "warp_fields.cu"
    sources = {"this": this, "empty": OUT_DIR / "empty.cu"}
    sources.update({f"{i}_{Path(p).stem}": Path(p) for i, p in enumerate(paths)})
    libs = build(sources)
    vec = int(re.search(r"constexpr int kVec = (\d+);", this.read_text()).group(1))
    page, buffer, shapes = field_inputs()
    views = warp_ops.split_fields(buffer, shapes)
    total = buffer.numel() // 2
    stream = torch.cuda.current_stream().cuda_stream
    nbytes = sum(warp_ops.warp_fields_bytes(page, f, "u8") for f in views)
    print(json.dumps({"buckets": [list(f.shape) for f in views], "samples": total,
                      "bound_ms": 1e3 * nbytes / cs.HBM_BYTES_PER_S, "bytes": nbytes}))

    empty = libs["empty"].launch_empty
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    new_blocks = -(-total // (256 * vec))
    old_blocks = [-(-f[..., 0].numel() // 256) for f in views]
    print(json.dumps({"source": "empty kernel, the grid of one launch", "blocks": new_blocks,
                      "ms_warm": cs.cuda_ms(lambda: empty(new_blocks, 1, 256, stream))}))
    print(json.dumps({"source": "empty kernel, a launch a bucket, one thread a sample",
                      "blocks": old_blocks, "ms_warm": cs.cuda_ms(
                          lambda: [empty(b, 1, 256, stream) for b in old_blocks])}))

    def launcher(name, pg, out, grouped):
        fn = libs[name].warp_fields
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        h, w, c = pg.shape
        f32 = int(pg.dtype == torch.float32)
        if grouped:
            calls = [(buffer.data_ptr(), out.data_ptr(), total)]
        else:  # each bucket into its own place of the same output
            calls = [(f.data_ptr(), out.data_ptr() + (f.data_ptr() - buffer.data_ptr()) // 8 * c,
                      f[..., 0].numel()) for f in views]
        args = [(pg.data_ptr(), fp, op, h, w, c, n, f32, 1, stream) for fp, op, n in calls]
        return lambda: [fn(*a) for a in args]

    page_f32 = page.float()
    runs = {}
    for pg in (page, page_f32):
        want = [warp_ops.warp_fields_plain(pg, f, "u8") for f in views]
        out = torch.empty((total, 3), dtype=torch.uint8, device="cuda")
        for name in (n for n in sources if n != "empty"):
            for grouped in (False, True):
                fn = launcher(name, pg, out, grouped)
                out.zero_()
                if any(rc != 0 for rc in fn()):
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                for got, f in zip(warp_ops.split_fields(out.view(-1), shapes, 3), want):
                    if not torch.equal(got, f):
                        raise AssertionError(f"{name} disagrees with the plain version")
                key = (name, "float32 page" if pg is page_f32 else "uint8 page",
                       "one launch" if grouped else "a launch a bucket")
                runs[key] = {"fn": fn, "warm": [], "cold": []}
    order = list(runs) + list(runs)[::-1]
    for key in order:
        runs[key]["warm"].append(cs.cuda_ms(runs[key]["fn"]))
        runs[key]["cold"].append(cs.cuda_ms(runs[key]["fn"], cold=True))
    for (name, page_kind, launches), t in runs.items():
        print(json.dumps({"source": os.path.relpath(sources[name]), "variant": name,
                          "page": page_kind, "launches": launches,
                          "ms_warm": t["warm"], "ms_cold": t["cold"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
