"""Pick the best writer embedding of a multi-embedding CTC recognizer:
the port of scripts/select_embed_id.py, with its arguments, stdout lines
and files.

    python3 -m pero_ocr_tpu_torch.scripts.select_embed_id -c config.ini \\
        -i images/ -x page_xml/ [--n-lines 100] [--n-clusters 100] \\
        [--representative-embed-ids 3,7] [--out dir/] [--device cuda|cpu]

The config's PageParser crops the lines of each page that has a Page XML
file (``LineCropper``: the hand-written CUDA field warp on the card, one
launch a page of 4 lines or more), the first ``--n-lines`` lines with a
transcription are kept, and the representative embeddings are either
the ones given, or one a k-means cluster of the embedding table
(:mod:`pero_ocr_tpu_torch.utils.kmeans`, sklearn's algorithm; a random
member of each cluster from numpy's global generator, or with
``--mean-cluster-embed`` the member nearest the cluster's mean), or all
of them.  The recognizer reads every line once a representative; the
lines' edit distances go to the host C++ in one call
(``levenshtein_batch_i32``; numpy on the CPU route).  The id with the
least CER is written into the OCR JSON as ``embed_id``.

``--device cpu`` runs the plain PyTorch versions.  The LMDB route
(``-l``/``-t``) exits with code 2: the port has no LMDB reader.
"""

from __future__ import annotations

import argparse
import configparser
import json
import logging
import os
import sys
import time

import numpy as np

from pero_ocr_tpu_torch import IMAGES, not_ported, resolve_device
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.page_parser import PageParser
from pero_ocr_tpu_torch.sequence_alignment import levenshtein_batch
from pero_ocr_tpu_torch.utils import native as native_lib
from pero_ocr_tpu_torch.utils.checkpoint import set_strict_loading
from pero_ocr_tpu_torch.utils.image_io import imread
from pero_ocr_tpu_torch.utils.kmeans import KMeans
from pero_ocr_tpu_torch.utils.paths import compose_path


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-i", "--input-image-path")
    parser.add_argument("-x", "--input-xml-path")
    parser.add_argument("-l", "--input-lmdb-path")
    parser.add_argument("-t", "--input-data-path")
    parser.add_argument("-b", "--batch-size", type=int, default=32)
    parser.add_argument("--n-clusters", type=int, default=100)
    parser.add_argument("--n-lines", type=int, default=100)
    parser.add_argument("--mean-cluster-embed", action="store_true")
    parser.add_argument("--representative-embed-ids", type=str,
                        help="Comma-separated; skips clustering.")
    parser.add_argument("--out", type=str)
    parser.add_argument("--allow-random-weights", action="store_true",
                        help="Run with RANDOM weights when a configured "
                             "checkpoint is missing (test/CI use).")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (the hand-written kernels; no CPU fallback) or cpu "
                             "(the plain PyTorch versions).")
    return parser.parse_args(argv)


def select_representative_embeddings(ocr_engine, n_clusters, mean_cluster_embedding=False):
    embeddings = ocr_engine.embedding_table()
    print(f"EMBEDDINGS SHAPE: {embeddings.shape}")
    kmeans = KMeans(n_clusters=n_clusters, random_state=0).fit(embeddings)
    out = []
    for i in range(n_clusters):
        members = np.where(kmeans.labels_ == i)[0]
        if len(members) == 0:
            continue
        if mean_cluster_embedding:
            center = embeddings[members].mean(axis=0)
            out.append(int(members[np.argmin(
                np.linalg.norm(embeddings[members] - center, axis=1))]))
        else:
            out.append(int(np.random.choice(members)))
    return out


def crops_from_images_and_xmls(page_parser, image_path, xml_path, n_lines):
    ignored = {"", ".xml", ".logits"}
    images = sorted(f for f in os.listdir(image_path)
                    if os.path.splitext(f)[1].lower() not in ignored)
    crops, gts = [], []
    for image_file in images:
        if len(crops) >= n_lines:
            break
        file_id = os.path.splitext(image_file)[0]
        xml_file = os.path.join(xml_path, file_id + ".xml")
        if not os.path.exists(xml_file):
            continue
        try:
            image = imread(os.path.join(image_path, image_file))
        except (ValueError, OSError):  # cv2.imread's None
            continue
        layout = PageLayout(file=xml_file)
        page_parser.line_cropper.process_page(image, layout)
        for line in layout.lines_iterator():
            if line.transcription and line.crop is not None:
                crops.append(line.crop.astype(np.uint8))
                gts.append(line.transcription)
                if len(crops) >= n_lines:
                    break
    return crops, gts


def main(argv=None):
    args = parse_arguments(argv)
    config = configparser.ConfigParser()
    config.read(args.config)

    images_and_xmls = args.input_image_path is not None and args.input_xml_path is not None
    if not images_and_xmls and args.input_lmdb_path is not None \
            and args.input_data_path is not None:
        logging.error(str(not_ported("select_embed_id's LMDB input (-l/-t: the lmdb package)",
                                     IMAGES)))
        sys.exit(2)
    device = resolve_device(args.device)
    if not args.allow_random_weights:
        set_strict_loading(True)

    page_parser = PageParser(config, device=device, config_path=os.path.dirname(args.config))
    engine = page_parser.ocr.ocr_engine
    engine.batch_size = args.batch_size

    if images_and_xmls:
        line_crops, gts = crops_from_images_and_xmls(
            page_parser, args.input_image_path, args.input_xml_path, args.n_lines)
    else:
        print("Invalid inputs.")
        sys.exit(-1)

    t_start = time.time()
    if args.representative_embed_ids is not None:
        representatives = [int(x) for x in args.representative_embed_ids.split(",")]
    elif args.n_clusters < (engine.embed_num or 0):
        representatives = select_representative_embeddings(
            engine, args.n_clusters, args.mean_cluster_embed)
    else:
        representatives = list(range(engine.embed_num or 1))
    print("REPRESENTATIVE EMBEDDING IDS: " + ",".join(str(x) for x in representatives))
    print()

    native = native_lib.use_native(None, device)
    cers = []
    for embed_id in representatives:
        engine.embed_id = embed_id
        t1 = time.time()
        transcriptions, _, _ = engine.process_lines(line_crops, no_logits=True)
        if args.out is not None:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{embed_id}.gt"), "w") as f:
                f.writelines(f"{x}\n" for x in gts)
            with open(os.path.join(args.out, f"{embed_id}.trans"), "w") as f:
                f.writelines(f"{x}\n" for x in transcriptions)
        char_sum = sum(len(gt) for gt in gts)
        char_dist = int(levenshtein_batch(
            [(list(gt), list(t)) for gt, t in zip(gts, transcriptions)], native).sum())
        if char_sum > 0:
            cers.append(100.0 * char_dist / char_sum)
            print(f"{embed_id} {cers[-1]:.2f} % CER [ {char_dist} / "
                  f"{char_sum} ] Time: {time.time() - t1:.2f}")
        else:
            cers.append(1e12)
            print(f"{embed_id} N/A % CER [ {char_dist} / {char_sum} ] "
                  f"Time: {time.time() - t1:.2f}")

    best = representatives[int(np.argmin(cers))]
    print()
    print(f"SELECTED EMBED ID WITH MIN CER: {best}")
    print(f"PROCESSING TIME {time.time() - t_start}")

    engine.config["embed_id"] = str(best)
    with open(compose_path(config["OCR"]["OCR_JSON"], os.path.dirname(args.config)),
              "w", encoding="utf8") as f:
        json.dump(engine.config, f, indent=4)


if __name__ == "__main__":
    main()
