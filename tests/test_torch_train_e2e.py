"""Training in the port, end to end, on the CPU (the port's mirror of
tests/test_end_to_end_training.py): the same tiny CTC recognizer is
trained with the port's trainer (``device="cpu"``, its own seeded
initialisation) on the same cv2-rendered lines and their cropper
warps, exported with the port's flax writer, and then read by the JAX
package's engine and by the port's engine.

Both engines must transcribe the training lines alike (the same
strings: both run the same float32 weights, and their logits agree
within the conversion tests' 1e-4), with the JAX test's bound on the
character error rate (< 0.05).
"""

import json

import numpy as np
import pytest
import torch

from pero_ocr_tpu.ocr.ctc_engine import CTCEngineLineOCR as JaxCTCEngine
from pero_ocr_tpu.sequence_alignment import levenshtein_distance
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.parallel import train
from pero_ocr_tpu_torch.utils import checkpoint, convert
from tests.test_end_to_end_training import CHARS, LINE_H, make_dataset
from tests.test_torch_cli import cores_share, torch_threads_share  # noqa: F401  (fixture)

STEPS, STOP_LOSS = 500, 0.05  # the JAX test's recipe: lr 3e-3, batch of 96 lines


def _training_set(rng):
    """The JAX test's lines: 48 rendered texts and their cropper warps,
    32 px of zeros on the left, zero-padded to 192 px."""
    from pero_ocr_tpu.core.crop_engine import EngineLineCropper

    texts, images = make_dataset(rng, 48)
    cropper = EngineLineCropper(line_height=LINE_H, poly=2, scale=1.0)
    warped = []
    for img in images:
        canvas = np.full((LINE_H + 40, img.shape[1] + 40, 3), 250, np.uint8)
        canvas[20:20 + LINE_H, 20:20 + img.shape[1]] = img
        baseline = np.array([[20, 20 + LINE_H], [20 + img.shape[1], 20 + LINE_H]], float)
        crop = cropper.crop(canvas, baseline, [float(LINE_H), 0.0])
        out = np.full((LINE_H, img.shape[1], 3), 250, np.uint8)
        w = min(crop.shape[1], img.shape[1])
        out[:, :w] = crop[:, :w]
        warped.append(out)
    train_texts, train_images = texts + texts, images + warped
    padded = np.zeros((len(train_images), LINE_H, 192, 3), np.uint8)
    for i, img in enumerate(train_images):
        padded[i, :, 32:32 + img.shape[1]] = img
    labels = np.zeros((len(train_texts), max(len(t) for t in train_texts)), np.int32)
    for i, t in enumerate(train_texts):
        labels[i, :len(t)] = [CHARS.index(c) for c in t]
    lengths = np.array([len(t) for t in train_texts], np.int32)
    return texts, images, padded.astype(np.float32) / 255.0, labels, lengths


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("port_trained")
    texts, images, batch, labels, lengths = _training_set(np.random.default_rng(0))
    spec = RecognizerSpec(num_classes=len(CHARS) + 1, line_height=LINE_H, conv_features=(16, 32),
                          subsampling=2, lstm_layers=1, lstm_features=48, dtype=torch.float32)
    model = CTCRecognizer(spec, generator=torch.Generator().manual_seed(0))
    optimizer = train.make_optimizer(3e-3)
    state = train.init_train_state(model, optimizer, device="cpu")
    step = train.make_train_step(model, optimizer)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, cores_share()))
    try:
        for i in range(STEPS):
            state, loss = step(state, batch, labels, lengths)
            if i % 25 == 0 and float(loss) < STOP_LOSS:
                break
    finally:
        torch.set_num_threads(threads)
    assert float(loss) < 0.5, f"training failed to converge: loss={float(loss)}"
    checkpoint.save_variables(convert.recognizer_params_to_flax(model), str(d / "model.ckpt"))
    cfg = {"characters": CHARS, "line_px_height": LINE_H, "line_vertical_scale": 1,
           "checkpoint": "model.ckpt",
           "net_spec": {"conv_features": [16, 32], "subsampling": 2, "lstm_layers": 1,
                        "lstm_features": 48, "dtype": "float32"}}
    (d / "ocr.json").write_text(json.dumps(cfg))
    return str(d / "ocr.json"), texts, images, model


def _cer(texts, transcriptions) -> float:
    errors = sum(int(levenshtein_distance(list(gt), list(hyp)))
                 for gt, hyp in zip(texts, transcriptions))
    return errors / sum(len(t) for t in texts)


@pytest.mark.usefixtures("torch_threads_share")  # the engines' small batches
def test_both_engines_read_the_ports_training_lines_alike(port_trained):
    ocr_json, texts, images, model = port_trained
    theirs, _, _ = JaxCTCEngine(ocr_json, batch_size=16).process_lines(images)
    engine = CTCEngineLineOCR(ocr_json, device="cpu")
    ours, _, _ = engine.process_lines(images)
    assert ours == theirs
    assert _cer(texts, ours) < 0.05, f"sample: gt={texts[:3]} hyp={ours[:3]}"
    # The engine's model is the trained module, weight for weight.
    for name, value in model.state_dict().items():
        assert torch.equal(engine.model.state_dict()[name], value), name
