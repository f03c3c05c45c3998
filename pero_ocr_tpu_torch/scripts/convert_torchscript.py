"""The reference's TorchScript model archives: the port of
scripts/convert_torchscript.py, with its modes and arguments.

The reference ships ParseNet and its CTC recognizer only as TorchScript
archives.  The port runs them natively (``torch.jit.load``), so it needs
no interpreter of their graphs.  Three modes:

inspect   Print the archive's op histogram and parameter table (the JAX
          report, without its marks of ops its interpreter lacks: the
          port runs every op).

verify    Has no meaning in the port: it compares the JAX interpreter's
          forward pass with torch's.  Exits with 2 and says so.

distill   Train a native model (the port's ParseNet or CTCRecognizer)
          against the archive as its teacher, on a folder of page or
          line images (or synthetic pages when none are given), and
          write a flax msgpack checkpoint for MODEL_PATH or the OCR
          JSON's ``checkpoint``.  It runs on CUDA.

Examples:
    python -m pero_ocr_tpu_torch.scripts.convert_torchscript inspect ParseNet.pt
    python -m pero_ocr_tpu_torch.scripts.convert_torchscript distill ocr.pt --family ctc \\
        --images 'lines/*.png' --out ocr_native.ckpt

``distill`` follows the JAX script step for step: one
``np.random.RandomState(0)`` draws the synthetic pages, then each step's
batch indices; images from ``--images`` are read and resized as cv2
does (:func:`pero_ocr_tpu_torch.utils.image_io.imread`,
:func:`pero_ocr_tpu_torch.utils.resize.resize_linear_u8_to`); the loss
is the MSE over the channels the two ParseNets share, or the frame-level
cross-entropy of the student's log-softmax against the teacher's
softmax; the optimizer is ``optax.adam``'s arithmetic
(:class:`pero_ocr_tpu_torch.parallel.optim.Adam`) on float32 weights
while the student computes in its dtype (bfloat16, the JAX default).
The student starts from the port's seeded initialisation, or from given
flax variables (:func:`distill`).
"""

from __future__ import annotations

import argparse
import glob
import logging
import sys
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pero_ocr_tpu_torch import UnreadableImage, resolve_device
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel import train
from pero_ocr_tpu_torch.parallel.optim import Adam
from pero_ocr_tpu_torch.utils import convert
from pero_ocr_tpu_torch.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.utils.image_io import imread
from pero_ocr_tpu_torch.utils.resize import resize_linear_u8_to
from pero_ocr_tpu_torch.utils.ts_adapters import (
    TSParseNetModel,
    TSRecognizerModel,
    load_torchscript,
)

logger = logging.getLogger("convert_torchscript")

PARSENET_SHAPE = (256, 320)
LINE_WIDTH = 512
VERIFY_MEANING = (
    "verify compares the JAX package's TorchScript interpreter with torch; the port "
    "runs archives with torch itself (torch.jit.load), so there is nothing to verify")


def inspect_report(path: str) -> str:
    """The archive's op histogram (of its inlined graph) and parameter
    table: the JAX ``inspect_torchscript`` report without its marks."""
    module = torch.jit.load(path, map_location="cpu").eval()
    ops = Counter(n.kind() for n in module.inlined_graph.nodes())
    lines = ["== op histogram =="]
    for kind, cnt in sorted(ops.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {cnt:4d}  {kind}")
    lines.append("== parameters ==")
    total = 0
    for name, p in module.named_parameters():
        lines.append(f"  {name}  {tuple(p.shape)} {p.dtype}")
        total += p.numel()
    for name, b in module.named_buffers():
        lines.append(f"  {name}  {tuple(b.shape)} {b.dtype} (buffer)")
    lines.append(f"== total parameters: {total} ==")
    return "\n".join(lines)


def cmd_inspect(args) -> int:
    print(inspect_report(args.model))
    return 0


def cmd_verify(args) -> int:
    print(VERIFY_MEANING, file=sys.stderr)
    return 2


def load_images(pattern: Optional[str], count: int, shape):
    """The first ``count`` images of the sorted glob ``pattern`` (BGR),
    each resized to ``shape`` (h, w); a file that cv2 cannot read is
    skipped with a warning, as the JAX script skips it, and one that
    only the port cannot read raises."""
    images = []
    for path in (sorted(glob.glob(pattern)) if pattern else [])[:count]:
        try:
            img = imread(path)
        except UnreadableImage as e:
            logger.warning("skipping %s: %s", path, e)
            continue
        images.append(resize_linear_u8_to(img, (shape[1], shape[0])))
    return images


def synthetic_pages(count: int, shape, rng: np.random.RandomState):
    """Text-like synthetic pages when no image folder is given: dark
    horizontal strokes on a light background, drawn from ``rng`` in the
    JAX script's order."""
    pages = []
    h, w = shape
    for _ in range(count):
        page = np.full((h, w), 235, np.uint8)
        y = 8
        while y + 10 < h:
            n_seg = rng.randint(3, 8)
            x = rng.randint(4, 20)
            for _ in range(n_seg):
                seg_w = rng.randint(10, max(12, w // n_seg - 8))
                if x + seg_w >= w:
                    break
                page[y: y + 6, x: x + seg_w] = rng.randint(10, 80)
                x += seg_w + rng.randint(4, 16)
            y += rng.randint(12, 20)
        pages.append(np.stack([page] * 3, axis=-1))
    return pages


def load_teacher(args, device):
    """The archive on ``device`` behind the port's model surface: NHWC
    images in [0, 1] in, NHWC maps or (N, T, C) logits out."""
    module = load_torchscript(args.model, device)
    if args.family == "parsenet":
        return TSParseNetModel(module, device)
    return TSRecognizerModel(module, device, line_height=args.line_height)


def input_shape(args):
    return PARSENET_SHAPE if args.family == "parsenet" else (args.line_height, LINE_WIDTH)


def make_student(args, teacher, dtype=torch.bfloat16, variables=None):
    """The native student on the CPU: the JAX script's architecture for
    ``args`` (a CTC student takes the archive's classes and subsampling;
    its stem is s2d for ``--stem conv`` too, as in the JAX script),
    seeded, or holding the flax ``variables``."""
    gen = torch.Generator().manual_seed(0)
    if args.family == "parsenet":
        model = ParseNet(stem=args.stem, dtype=dtype, generator=gen)
        from_flax = convert.parsenet_params_from_flax
    else:
        spec = RecognizerSpec(
            num_classes=teacher.spec.num_classes, line_height=args.line_height,
            subsampling=teacher.spec.subsampling,
            stem=args.stem if args.stem != "conv" else "s2d", dtype=dtype)
        model = CTCRecognizer(spec, generator=gen)
        from_flax = convert.recognizer_params_from_flax
    if variables is not None:
        model.load_state_dict(from_flax(variables), strict=True)
    return model


def distill_loss(family: str, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The JAX script's loss: the MSE over the map channels both models
    have, or the mean over frames of the cross-entropy of the student's
    log-softmax against the teacher's softmax."""
    if family == "parsenet":
        ch = min(pred.shape[-1], target.shape[-1])
        return torch.mean((pred[..., :ch] - target[..., :ch]) ** 2)
    pred = F.log_softmax(pred, dim=-1)
    tgt = F.softmax(target, dim=-1)
    t = min(pred.shape[1], tgt.shape[1])
    return -torch.mean(torch.sum(tgt[:, :t] * pred[:, :t], dim=-1))


def distill(args, device=None, variables=None, dtype=torch.bfloat16):
    """The distillation of ``args`` (the ``distill`` mode's arguments) on
    ``device`` (CUDA unless the caller passes "cpu"), the student
    starting from the flax ``variables`` when given.  Writes the
    checkpoint to ``args.out`` and returns a dict: ``losses`` (a float
    a step), ``indices`` (each step's batch indices), ``model``,
    ``state`` and ``teacher``."""
    device = resolve_device(device)
    teacher = load_teacher(args, device)
    rng = np.random.RandomState(0)
    shape = input_shape(args)
    images = load_images(args.images, args.num_samples, shape)
    if not images:
        images = synthetic_pages(args.num_samples, shape, rng)
    model = make_student(args, teacher, dtype, variables)
    optimizer = Adam(args.learning_rate)
    state = train.init_train_state(model, optimizer, device)
    step = train.make_loss_step(
        model, optimizer, lambda m, batch, target: distill_loss(args.family, m(batch), target))
    images_t = torch.from_numpy(np.stack(images).astype(np.float32) / 255.0).to(device)
    losses, indices = [], []
    for it in range(args.steps):
        idx = rng.randint(0, len(images_t), args.batch)
        indices.append(idx)
        batch = images_t[torch.from_numpy(idx).to(device)]
        with torch.no_grad():
            target = teacher(batch)
        state, loss = step(state, batch, target)
        losses.append(loss)
        if it % 50 == 0 or it == args.steps - 1:
            print(f"step {it}: distill loss {float(loss):.5f}")
    to_flax = (convert.parsenet_params_to_flax if args.family == "parsenet"
               else convert.recognizer_params_to_flax)
    save_variables(to_flax(model, train.float32_state_dict(model, state)), args.out)
    print(f"wrote native checkpoint {args.out}")
    return {"losses": [float(v) for v in losses], "indices": indices, "model": model,
            "state": state, "teacher": teacher}


def cmd_distill(args) -> int:
    distill(args)
    return 0


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="op histogram and parameter table")
    p.add_argument("model")

    p = sub.add_parser("verify", help="no meaning in the port: " + VERIFY_MEANING,
                       description="No meaning in the port: " + VERIFY_MEANING + ".")
    p.add_argument("model")
    p.add_argument("--family", choices=["parsenet", "ctc"], default="parsenet")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--tolerance", type=float, default=1e-3)

    p = sub.add_parser("distill", help="train a native model against the archive")
    p.add_argument("model")
    p.add_argument("--family", choices=["parsenet", "ctc"], default="parsenet")
    p.add_argument("--images", default=None,
                   help="glob of training images (default: synthetic)")
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num-samples", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--line-height", type=int, default=32)
    p.add_argument("--stem", default="s2d", help="native student stem (s2d or conv)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    logging.basicConfig(level=logging.INFO)
    return {"inspect": cmd_inspect, "verify": cmd_verify, "distill": cmd_distill}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
