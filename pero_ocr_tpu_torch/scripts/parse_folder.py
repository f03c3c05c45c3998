"""Folder OCR on one GPU: the port of scripts/parse_folder.py.

    python3 -m pero_ocr_tpu_torch.scripts.parse_folder \\
        -c config.ini -i images/ --output-xml-path page_xml/ [--fast-pipeline] \\
        [--output-logit-path logits/] [--output-alto-path alto/]

It reads the config and its OCR JSON, loads the flax msgpack checkpoints
they name into the port's models, decodes the pages (PNG or binary PNM,
:mod:`pero_ocr_tpu_torch.utils.image_io`) and writes, per page, a Page
XML file, a ``.logits`` pickle of the lines' sparse logits and an ALTO
file with word boxes from the forced alignment, each where asked.
Without ``--fast-pipeline`` each page goes through
``PageParser.process_page`` (the stage-by-stage path; the line crops are
sampled by the hand-written CUDA field warp), with the next page decoded
on a worker thread, and a page that fails is reported and skipped, as
the JAX command line's ``Computator`` does.  With ``--fast-pipeline``
the page batches go through ``FastPagePipeline.process_pages`` (stage B
warps the lines with the fused CUDA kernel); a config that the fast path
would run differently (``FastPagePipeline.unsupported_features``) falls
back to the stage-by-stage path, as in the JAX command line.
``--device cpu`` runs the plain PyTorch versions instead.  The host
geometry (connected components, paragraph clustering, the fast path's
parse) and the ALTO output's forced alignment follow the device too: the
port's C++ on CUDA, numpy/scipy on the CPU.

Options and config features the port lacks exit with code 2 and name
their ROADMAP item, rather than change what the run means.  The JAX
command line's ``prime`` (decoding the first batch, then starting its
host prep while the rest decode) only overlaps work and is left out.
"""

from __future__ import annotations

import argparse
import configparser
import logging
import os
import re
import sys
import threading
import time
import traceback
from queue import Queue
from typing import List, Optional, Set

from pero_ocr_tpu_torch import (
    CROP_TRANSPORT, IMAGES, SCALE_OUT, STAGE_BY_STAGE, not_ported, resolve_device,
)
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.document.page_parser import LayoutExtractor, PageParser
from pero_ocr_tpu_torch.ops.warp import warp_fields, warp_lines
from pero_ocr_tpu_torch.utils import native as native_lib
from pero_ocr_tpu_torch.utils.checkpoint import set_strict_loading
from pero_ocr_tpu_torch.utils.image_io import imread
from pero_ocr_tpu_torch.utils.timing import reset_timing, stage_timer, timing_report

logger = logging.getLogger(__name__)

PAGE_BATCH = 4  # the JAX command line's page batch on one device


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Page images -> Page XML, logits and ALTO with the PyTorch/CUDA port."
    )
    parser.add_argument("-c", "--config", required=True, help="Path to input config file.")
    parser.add_argument("-s", "--skip-processed", action="store_true",
                        help="If set, already processed files are skipped.")
    parser.add_argument("-i", "--input-image-path")
    parser.add_argument("-x", "--input-xml-path")
    parser.add_argument("--input-logit-path")
    parser.add_argument("--output-xml-path")
    parser.add_argument("--output-render-path")
    parser.add_argument("--output-line-path")
    parser.add_argument("--output-logit-path")
    parser.add_argument("--output-alto-path")
    parser.add_argument("--output-transcriptions-file-path")
    parser.add_argument("--skipp-missing-xml", action="store_true",
                        help="Skip images which have missing xml.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (the hand-written kernels; no CPU fallback) or cpu "
                             "(the plain PyTorch versions).")
    parser.add_argument("--profile", metavar="DIR")
    parser.add_argument("--timing-report", action="store_true",
                        help="Print per-stage timing table at the end.")
    parser.add_argument("--fast-pipeline", action="store_true",
                        help="Device-resident batched pipeline (page transport); "
                             "without it, pages run stage by stage.")
    parser.add_argument("--transport-bits", type=int, choices=[2, 4, 8], default=4,
                        help="Upload depth: 4 packs two pixels per byte, 8 sends raw "
                             "grayscale; 2 needs the crop transport.")
    parser.add_argument("--canvas-bits", type=int, choices=[2, 4, 8], default=None)
    parser.add_argument("--transport", choices=["page", "crops"], default="page")
    parser.add_argument("--dp", type=int, default=0, metavar="N")
    parser.add_argument("--process-count", type=int, default=1)
    parser.add_argument("--shard-index", type=int, default=0,
                        help="This host's shard number (0-based): it processes every "
                             "shard-count'th file of the sorted listing.")
    parser.add_argument("--shard-count", type=int, default=1,
                        help="Total hosts sharding this folder.")
    parser.add_argument("--allow-random-weights", action="store_true",
                        help="Run with RANDOM weights when a configured checkpoint is "
                             "missing (test use). The default is a hard error.")
    return parser.parse_args(argv)


def setup_logging(config):
    level = logging.getLevelName(config.get("LOGGING_LEVEL", fallback="WARNING"))
    logging.basicConfig(
        format="[%(levelname)s] %(asctime)s - %(name)s - %(message)s", level=level
    )
    logging.getLogger("pero_ocr_tpu_torch").setLevel(level)


def shard_file_lists(ids, images, shard_index: int, shard_count: int):
    """Deterministic round-robin shard of the sorted file listing: pages
    are independent, so hosts need only agree on the listing."""
    if not (0 <= shard_index < shard_count):
        raise ValueError(f"--shard-index {shard_index} outside [0, {shard_count})")
    keep = slice(shard_index, None, shard_count)
    return ids[keep], images[keep]


def get_value_or_none(config, section, key):
    return config[section][key] if config.has_option(section, key) else None


def load_already_processed_files_in_directory(directory: Optional[str]) -> Set[str]:
    done = set()
    if directory is not None:
        regex = re.compile(r"(.+?)(\.logits|\.xml|\.jpg)")
        for f in os.listdir(directory):
            matched = regex.match(f)
            if matched:
                done.add(matched.groups()[0])
    return done


def load_already_processed_files(directories: List[Optional[str]]) -> Set[str]:
    """A page is done only when present in ALL requested output dirs."""
    done: Set[str] = set()
    first = True
    for directory in directories:
        if directory is None:
            continue
        files = load_already_processed_files_in_directory(directory)
        done = files if first else done.intersection(files)
        first = False
    return done


def refusals(args, paths) -> List[str]:
    """What this run asks for that the port lacks, each with its ROADMAP
    item.  ``paths``: the PARSE_FOLDER paths after the command line's
    overrides."""
    asked = [
        (paths["INPUT_XML_PATH"], "-x/--input-xml-path (re-OCR of existing layouts)",
         CROP_TRANSPORT),
        (paths["OUTPUT_LINE_PATH"], "--output-line-path (line crops)", CROP_TRANSPORT),
        (paths["OUTPUT_RENDER_PATH"], "--output-render-path (JPEG renders)", IMAGES),
        (args.transport == "crops", "--transport crops", CROP_TRANSPORT),
        (args.transport_bits == 2, "--transport-bits 2", CROP_TRANSPORT),
        (args.canvas_bits is not None, "--canvas-bits", CROP_TRANSPORT),
        (args.dp > 1, "--dp", SCALE_OUT),
        (args.profile, "--profile (a torch.profiler trace)", SCALE_OUT),
        (args.process_count > 1, "--process-count", STAGE_BY_STAGE),
    ]
    return [str(not_ported(what, item)) for flag, what, item in asked if flag]


def refuse(messages: List[str]) -> None:
    for message in messages:
        logging.error(message)
    sys.exit(2)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    reset_timing()  # the report covers this run
    config_path = args.config
    if not os.path.isfile(config_path):
        print(f'ERROR: Config file does not exist: "{config_path}".')
        sys.exit(-1)

    config = configparser.ConfigParser()
    config.read(config_path)
    if "PARSE_FOLDER" not in config:
        config.add_section("PARSE_FOLDER")
    overrides = {
        "INPUT_IMAGE_PATH": args.input_image_path,
        "INPUT_XML_PATH": args.input_xml_path,
        "INPUT_LOGIT_PATH": args.input_logit_path,
        "OUTPUT_XML_PATH": args.output_xml_path,
        "OUTPUT_RENDER_PATH": args.output_render_path,
        "OUTPUT_LINE_PATH": args.output_line_path,
        "OUTPUT_LOGIT_PATH": args.output_logit_path,
        "OUTPUT_ALTO_PATH": args.output_alto_path,
    }
    for key, value in overrides.items():
        if value is not None:
            config["PARSE_FOLDER"][key] = value
    setup_logging(config["PARSE_FOLDER"])
    paths = {key: get_value_or_none(config, "PARSE_FOLDER", key) for key in overrides}

    refused = refusals(args, paths)
    if refused:
        refuse(refused)
    device = resolve_device(args.device)
    if not args.allow_random_weights:
        # A typo'd checkpoint path must fail loudly, never produce a
        # garbage-text run.
        set_strict_loading(True)

    with stage_timer("cli/build"):
        page_parser = PageParser(config, device=device, config_path=os.path.dirname(config_path))
    unported = [name for lp in page_parser.layout_parsers if isinstance(lp, LayoutExtractor)
                for name in lp.unported_options()]
    if unported:
        refuse([str(not_ported(f"[LAYOUT_PARSER] {', '.join(unported)}", STAGE_BY_STAGE))])
    output_logit_path = paths["OUTPUT_LOGIT_PATH"]
    output_alto_path = paths["OUTPUT_ALTO_PATH"]
    # No CTC logits, no ALTO or logits files (the JAX command line's
    # preflight).
    if not page_parser.provides_ctc_logits and output_alto_path:
        logging.error("Cannot create ALTO with current PageParser "
                      "(transformer outputs are incompatible)")
        sys.exit(2)
    if not page_parser.provides_ctc_logits and output_logit_path:
        logging.error("Cannot store logits with current PageParser "
                      "(transformer outputs are incompatible)")
        sys.exit(2)
    fast_pipeline = args.fast_pipeline
    if fast_pipeline:
        unsupported = FastPagePipeline.unsupported_features(page_parser)
        if unsupported:
            logging.warning("--fast-pipeline does not support %s; falling back to the "
                            "stage-by-stage path.", ", ".join(unsupported))
            fast_pipeline = False

    input_image_path = paths["INPUT_IMAGE_PATH"]
    output_xml_path = paths["OUTPUT_XML_PATH"]
    if paths["INPUT_LOGIT_PATH"] is not None:
        logger.warning("Logit path specified and Page XML path not specified. "
                       "Logits will be ignored.")
    if input_image_path is None:
        raise Exception(
            "INPUT_IMAGE_PATH has to be specified (INPUT_XML_PATH needs the crop "
            f"transport). It is missing in {config_path}."
        )
    for path in (output_xml_path, output_logit_path, output_alto_path):
        if path is not None:
            os.makedirs(path, exist_ok=True)
    outputs = PageOutputs(output_xml_path, output_logit_path, output_alto_path,
                          native_lib.use_native(None, device))

    ignored = {"", ".xml", ".logits"}
    images_to_process = sorted(
        f for f in os.listdir(input_image_path)
        if os.path.splitext(f)[1].lower() not in ignored
    )
    ids_to_process = [os.path.splitext(f)[0] for f in images_to_process]
    if args.shard_count > 1:
        ids_to_process, images_to_process = shard_file_lists(
            ids_to_process, images_to_process, args.shard_index, args.shard_count,
        )
        logger.info("Shard %d/%d: %d file(s).", args.shard_index, args.shard_count,
                    len(ids_to_process))
    if args.skip_processed:
        done = load_already_processed_files([output_xml_path, output_logit_path])
        if done:
            logger.info("Already processed %d file(s).", len(done))
            images_to_process = [
                img for fid, img in zip(ids_to_process, images_to_process) if fid not in done
            ]
            ids_to_process = [fid for fid in ids_to_process if fid not in done]

    t_start = time.time()
    if fast_pipeline:
        results = run_fast(page_parser, args, input_image_path, images_to_process,
                           ids_to_process, outputs)
    else:
        results = run_staged(page_parser, input_image_path, images_to_process,
                             ids_to_process, outputs)

    if args.output_transcriptions_file_path is not None:
        with open(args.output_transcriptions_file_path, "w", encoding="utf-8") as f:
            for page_lines in results:
                print("\n".join(page_lines), file=f)
    if ids_to_process:
        logger.info("AVERAGE PROCESSING TIME %s", (time.time() - t_start) / len(ids_to_process))
    if args.timing_report:
        print(timing_report())
        print(f"warp_lines kernel launches: {warp_lines.launches}")
        print(f"warp_fields kernel launches: {warp_fields.launches}")


class PageOutputs:
    """The files written for each page, in the JAX command line's order:
    Page XML, the logits pickle, ALTO.  ``native``: the route of the
    ALTO output's forced alignment."""

    def __init__(self, xml_path: Optional[str], logit_path: Optional[str],
                 alto_path: Optional[str], native: bool):
        self.xml_path = xml_path
        self.logit_path = logit_path
        self.alto_path = alto_path
        self.native = native

    @property
    def want_logits(self) -> bool:
        return bool(self.logit_path or self.alto_path)

    def write(self, layout: PageLayout, file_id: str) -> None:
        if self.xml_path is not None:
            with stage_timer("cli/write_xml"):
                layout.to_pagexml(os.path.join(self.xml_path, file_id + ".xml"))
        if self.logit_path is not None:
            with stage_timer("cli/write_logits"):
                layout.save_logits(os.path.join(self.logit_path, file_id + ".logits"))
        if self.alto_path is not None:
            with stage_timer("cli/write_alto"):
                layout.to_altoxml(os.path.join(self.alto_path, file_id + ".xml"),
                                  native=self.native)


def run_fast(page_parser, args, input_image_path, images_to_process, ids_to_process,
             outputs: PageOutputs) -> List[List[str]]:
    """The ``--fast-pipeline`` loop: decode every page, then stream the
    page batches through ``FastPagePipeline``.  Returns each page's
    transcription lines."""
    with stage_timer("cli/build"):
        fast = FastPagePipeline.from_page_parser(
            page_parser, transport_bits=args.transport_bits, page_batch=PAGE_BATCH,
            want_logits=outputs.want_logits,
        )
    results = []
    with stage_timer("cli/pages"):
        images = []
        for f in images_to_process:
            with stage_timer("cli/decode"):
                images.append(imread(os.path.join(input_image_path, f)))
        for layout in fast.process_pages(images, ids_to_process):
            outputs.write(layout, layout.id)
            results.append([
                f"{layout.id}-{line.id}.jpg {line.transcription}"
                for line in layout.lines_iterator() if line.transcription
            ])
            print(f"DONE {layout.id} (fast pipeline)", flush=True)
    return results


class ImagePrefetcher:
    """Decodes the next pages on a worker thread while the current one
    is processed; a page that fails to decode is handed on as its
    exception."""

    def __init__(self, image_dir: str, file_names: List[str]):
        self.image_dir = image_dir
        self.queue: Queue = Queue(maxsize=2)
        self.thread = threading.Thread(target=self._worker, args=(file_names,), daemon=True)
        self.thread.start()

    def _worker(self, file_names):
        for name in file_names:
            try:
                with stage_timer("cli/decode"):
                    self.queue.put(imread(os.path.join(self.image_dir, name)))
            except Exception as e:  # handed to the page's own error report
                self.queue.put(e)

    def get(self):
        return self.queue.get()


def process_one(page_parser, image, file_id: str, index: int, count: int,
                outputs: PageOutputs) -> List[str]:
    """One page through ``PageParser.process_page`` and into its files
    (the JAX ``Computator``): a failure is printed and the page skipped.
    Returns the page's transcription lines."""
    print(f"Processing {file_id}")
    t1 = time.time()
    annotations = []
    try:
        if isinstance(image, Exception):
            raise image
        page_layout = PageLayout(id=file_id, page_size=(image.shape[0], image.shape[1]))
        page_layout = page_parser.process_page(image, page_layout)
        outputs.write(page_layout, file_id)
        for line in sorted(page_layout.lines_iterator(), key=lambda x: x.id):
            if line.transcription:
                annotations.append(f"{file_id}-{line.id}.jpg " + line.transcription)
    except KeyboardInterrupt:
        traceback.print_exc()
        print("Terminated by user.")
        sys.exit()
    except Exception as e:
        print(f"ERROR: Failed to process file {file_id}.")
        print(e)
        traceback.print_exc()
    print("DONE {current}/{total} ({percentage:.2f} %) [id: {file_id}] Time:{time:.2f}".format(
        current=index + 1, total=count, percentage=(index + 1) / count * 100,
        file_id=file_id, time=time.time() - t1), flush=True)
    return annotations


def run_staged(page_parser, input_image_path, images_to_process, ids_to_process,
               outputs: PageOutputs) -> List[List[str]]:
    """The stage-by-stage loop: one page at a time, the next decoded on
    a worker thread.  Returns each page's transcription lines."""
    results = []
    with stage_timer("cli/pages"):
        prefetcher = ImagePrefetcher(input_image_path, images_to_process)
        for index, file_id in enumerate(ids_to_process):
            results.append(process_one(page_parser, prefetcher.get(), file_id, index,
                                       len(ids_to_process), outputs))
    return results


if __name__ == "__main__":
    main()
