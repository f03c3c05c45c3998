"""Folder OCR on one GPU: the port of scripts/parse_folder.py.

    python3 -m pero_ocr_tpu_torch.scripts.parse_folder \\
        -c config.ini -i images/ --output-xml-path page_xml/ [--fast-pipeline] \\
        [--transport crops] [--output-logit-path logits/] [--output-alto-path alto/]
    python3 -m pero_ocr_tpu_torch.scripts.parse_folder \\
        -c ocr_only.ini -i images/ -x page_xml_in/ [--input-logit-path logits/] \\
        --output-xml-path page_xml/ [--fast-pipeline]

It reads the config and its OCR JSON, loads the flax msgpack checkpoints
(or a reference transformer's torch ``.pt``) they name into the port's
models, decodes the pages (PNG or binary PNM,
:mod:`pero_ocr_tpu_torch.utils.image_io`) and writes, per page, a Page
XML file, a ``.logits`` pickle of the lines' sparse logits and an ALTO
file with word boxes from the forced alignment, each where asked.
Without ``--fast-pipeline`` each page goes through
``PageParser.process_page`` (the stage-by-stage path; the line crops are
sampled by the hand-written CUDA field warp; with ``RUN_DECODER`` the
lines then go through the beam search with the character LM; with
``[OCR] METHOD = transformer`` the transformer engine recognizes them,
and ``--timing-report`` lists its ``ocr/encode`` and ``ocr/decode``
times), with the next page decoded on a worker thread, and a page that fails is reported and skipped, as
the JAX command line's ``Computator`` does.  With ``--fast-pipeline``
the page batches go through ``FastPagePipeline.process_pages``: on the
page transport stage B warps the lines with the fused CUDA kernel; with
``--transport crops`` the host warps them and only the crops and a
small layout canvas reach the card (``--transport-bits 2`` and
``--canvas-bits`` pack them further).  A config that the fast path
would run differently (``FastPagePipeline.unsupported_features``) falls
back to the stage-by-stage path, as in the JAX command line.

``-x`` re-OCRs existing Page XML: stage by stage each page's layout is
read from its XML (and with ``--input-logit-path`` its lines' logits
from its ``.logits`` file, which a config with ``RUN_DECODER`` and no
OCR decodes) before ``process_page``, as the JAX ``Computator`` does;
with ``--fast-pipeline`` and a config without layout stages the lines go
through ``FastPagePipeline.process_existing_layouts`` (the crop
transport's recognize-only loop), else the run falls back to the
stage-by-stage path.  Without ``-i`` the pages are the XML files'.
``--device cpu`` runs the plain PyTorch versions instead.  The host
geometry (connected components, paragraph clustering, the fast path's
parse) and the ALTO output's forced alignment follow the device too: the
port's C++ on CUDA, numpy/scipy on the CPU.

Options and config features the port lacks exit with code 2 and name
their ROADMAP item, rather than change what the run means: line crops
and renders (``--output-line-path``, ``--output-render-path``: JPEG
files; the line crops' LMDB store also needs the lmdb package),
``--dp``, ``--profile``, ``--process-count`` and the layout method
``REGION_SIMPLE_THRESHOLD``.
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

from pero_ocr_tpu_torch import IMAGES, SCALE_OUT, STAGE_BY_STAGE, not_ported, resolve_device
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.document.page_parser import UNPORTED_LAYOUT_METHODS, PageParser
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
                        help="Device-resident batched pipeline; without it, pages run "
                             "stage by stage.")
    parser.add_argument("--transport-bits", type=int, choices=[2, 4, 8], default=4,
                        help="Fast-pipeline upload depth: 4 packs two pixels per byte, 8 "
                             "sends raw grayscale; 2 (crop transport only) packs four "
                             "crop pixels per byte while the layout canvas stays 4-bit.")
    parser.add_argument("--canvas-bits", type=int, choices=[2, 4, 8], default=None,
                        help="Fast-pipeline layout-canvas packing (crop transport only); "
                             "the default follows --transport-bits.")
    parser.add_argument("--transport", choices=["page", "crops"], default="page",
                        help="Fast-pipeline transport: 'page' uploads the pages and warps "
                             "the lines on the card; 'crops' uploads a small layout "
                             "canvas and the lines warped on the host.")
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


def refusals(args, paths, config) -> List[str]:
    """What this run asks for that the port lacks, each with its ROADMAP
    item.  ``paths``: the PARSE_FOLDER paths after the command line's
    overrides; ``config``: the ini."""
    line_path = paths["OUTPUT_LINE_PATH"]
    asked = [
        (line_path and "lmdb" in line_path,
         "--output-line-path into an LMDB store (the lmdb package, and JPEG encoding)", IMAGES),
        (line_path and "lmdb" not in line_path, "--output-line-path (JPEG line crops)", IMAGES),
        (paths["OUTPUT_RENDER_PATH"], "--output-render-path (JPEG renders)", IMAGES),
        (args.dp > 1, "--dp", SCALE_OUT),
        (args.profile, "--profile (a torch.profiler trace)", SCALE_OUT),
        (args.process_count > 1, "--process-count", STAGE_BY_STAGE),
    ] + [
        (config.getboolean("PAGE_PARSER", "RUN_LAYOUT_PARSER", fallback=False),
         f"[{section}] METHOD = {config[section]['METHOD']}", STAGE_BY_STAGE)
        for section in config.sections()
        if re.fullmatch(r"LAYOUT_PARSER_[1-9]", section)
        and config[section].get("METHOD") in UNPORTED_LAYOUT_METHODS
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

    refused = refusals(args, paths, config)
    if refused:
        refuse(refused)
    device = resolve_device(args.device)
    if not args.allow_random_weights:
        # A typo'd checkpoint path must fail loudly, never produce a
        # garbage-text run.
        set_strict_loading(True)

    with stage_timer("cli/build"):
        page_parser = PageParser(config, device=device, config_path=os.path.dirname(config_path))
    output_logit_path = paths["OUTPUT_LOGIT_PATH"]
    output_alto_path = paths["OUTPUT_ALTO_PATH"]
    input_image_path = paths["INPUT_IMAGE_PATH"]
    input_xml_path = paths["INPUT_XML_PATH"]
    input_logit_path = paths["INPUT_LOGIT_PATH"]
    output_xml_path = paths["OUTPUT_XML_PATH"]
    # No CTC logits, no ALTO or logits files (the JAX command line's
    # preflight); stored logits can make the ALTO.
    if not page_parser.provides_ctc_logits and not input_logit_path and output_alto_path:
        logging.error("Cannot create ALTO with current PageParser "
                      "(transformer outputs are incompatible)")
        sys.exit(2)
    if not page_parser.provides_ctc_logits and output_logit_path:
        logging.error("Cannot store logits with current PageParser "
                      "(transformer outputs are incompatible)")
        sys.exit(2)
    fast_pipeline = args.fast_pipeline
    # Re-OCR of input XML with no layout stages: the recognize-only fast
    # path; with layout stages they must re-run on the input layout, so
    # the run goes stage by stage.
    fast_reocr = input_xml_path is not None and not page_parser.layout_parsers
    if fast_pipeline:
        unsupported = FastPagePipeline.unsupported_features(page_parser)
        if input_xml_path is not None and not fast_reocr:
            unsupported.append("INPUT_XML_PATH with layout stages (stages must re-run on the "
                               "input layout)")
        if unsupported:
            logging.warning("--fast-pipeline does not support %s; falling back to the "
                            "stage-by-stage path.", ", ".join(unsupported))
            fast_pipeline = False
    if fast_pipeline:
        if args.transport_bits == 2 and args.transport != "crops":
            logging.error("--transport-bits 2 requires --transport crops "
                          "(the layout page never drops below 4-bit).")
            sys.exit(2)
        if args.canvas_bits is not None and args.transport != "crops":
            logging.error("--canvas-bits requires --transport crops.")
            sys.exit(2)

    if input_logit_path is not None and input_xml_path is None:
        input_logit_path = None
        logger.warning("Logit path specified and Page XML path not specified. "
                       "Logits will be ignored.")
    for path in (output_xml_path, output_logit_path, output_alto_path):
        if path is not None:
            os.makedirs(path, exist_ok=True)
    outputs = PageOutputs(output_xml_path, output_logit_path, output_alto_path,
                          native_lib.use_native(None, device))

    if input_image_path is not None:
        ignored = {"", ".xml", ".logits"}
        images_to_process = sorted(
            f for f in os.listdir(input_image_path)
            if os.path.splitext(f)[1].lower() not in ignored
        )
        ids_to_process = [os.path.splitext(f)[0] for f in images_to_process]
    elif input_xml_path is not None:
        xmls = sorted(f for f in os.listdir(input_xml_path) if os.path.splitext(f)[1] == ".xml")
        images_to_process = [None] * len(xmls)
        ids_to_process = [os.path.splitext(f)[0] for f in xmls]
    else:
        raise Exception("Either INPUT_IMAGE_PATH or INPUT_XML_PATH has to be specified. "
                        f"Both are missing in {config_path}.")
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
    if input_xml_path and args.skipp_missing_xml:
        kept = [(fid, img) for fid, img in zip(ids_to_process, images_to_process)
                if os.path.exists(os.path.join(input_xml_path, fid + ".xml"))]
        ids_to_process = [fid for fid, _ in kept]
        images_to_process = [img for _, img in kept]

    t_start = time.time()
    if fast_pipeline:
        results = run_fast(page_parser, args, input_image_path, images_to_process,
                           ids_to_process, outputs, input_xml_path if fast_reocr else None)
    else:
        results = run_staged(page_parser, input_image_path, images_to_process,
                             ids_to_process, outputs, input_xml_path, input_logit_path)

    if args.output_transcriptions_file_path is not None:
        with open(args.output_transcriptions_file_path, "w", encoding="utf-8") as f:
            for page_lines in results:
                print("\n".join(page_lines), file=f)
    if page_parser.decoder:
        logger.info(page_parser.decoder.decoding_summary())
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
             outputs: PageOutputs, input_xml_path: Optional[str] = None) -> List[List[str]]:
    """The ``--fast-pipeline`` loop: decode the first page batch, start
    its host prep (the crop transport's ``prime``), decode the rest, then
    stream the page batches through ``FastPagePipeline``.  With
    ``input_xml_path`` (a config without layout stages) the pages' input
    layouts are re-OCRed instead.  Returns each page's transcription
    lines."""
    if input_image_path is None:
        raise ValueError("--fast-pipeline reads the pages from INPUT_IMAGE_PATH (-i)")
    with stage_timer("cli/build"):
        fast = FastPagePipeline.from_page_parser(
            page_parser, transport_bits=args.transport_bits, page_batch=PAGE_BATCH,
            want_logits=outputs.want_logits, transport=args.transport,
            canvas_bits=args.canvas_bits, reocr=input_xml_path is not None,
        )
    def decode(names):
        pages = []
        for f in names:
            with stage_timer("cli/decode"):
                pages.append(imread(os.path.join(input_image_path, f)))
        return pages

    results = []
    with stage_timer("cli/pages"):
        images = decode(images_to_process[: fast.page_batch])
        if input_xml_path is None:
            fast.prime(images)
        images += decode(images_to_process[fast.page_batch:])
        if input_xml_path is not None:
            layouts = []
            for fid in ids_to_process:
                layout = PageLayout(file=os.path.join(input_xml_path, fid + ".xml"))
                layout.id = fid  # the outputs are named by the file id
                layouts.append(layout)
            stream = fast.process_existing_layouts(images, layouts)
        else:
            stream = fast.process_pages(images, ids_to_process)
        for layout in stream:
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
    exception, a page without an image file as None."""

    def __init__(self, image_dir: Optional[str], file_names: List[Optional[str]]):
        self.image_dir = image_dir
        self.queue: Queue = Queue(maxsize=2)
        self.thread = threading.Thread(target=self._worker, args=(file_names,), daemon=True)
        self.thread.start()

    def _worker(self, file_names):
        for name in file_names:
            if name is None or self.image_dir is None:
                self.queue.put(None)
                continue
            try:
                with stage_timer("cli/decode"):
                    self.queue.put(imread(os.path.join(self.image_dir, name)))
            except Exception as e:  # handed to the page's own error report
                self.queue.put(e)

    def get(self):
        return self.queue.get()


def process_one(page_parser, image, file_id: str, index: int, count: int,
                outputs: PageOutputs, input_xml_path: Optional[str] = None,
                input_logit_path: Optional[str] = None) -> List[str]:
    """One page through ``PageParser.process_page`` and into its files
    (the JAX ``Computator``): the layout from ``input_xml_path``'s
    ``<file_id>.xml`` when given, the lines' logits from
    ``input_logit_path``'s ``<file_id>.logits``; a failure is printed
    and the page skipped.  Returns the page's transcription lines."""
    print(f"Processing {file_id}")
    t1 = time.time()
    annotations = []
    try:
        if isinstance(image, Exception):
            raise image
        if input_xml_path:
            page_layout = PageLayout(file=os.path.join(input_xml_path, file_id + ".xml"))
        else:
            page_layout = PageLayout(id=file_id, page_size=(image.shape[0], image.shape[1]))
        if input_logit_path is not None:
            page_layout.load_logits(os.path.join(input_logit_path, file_id + ".logits"))
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
               outputs: PageOutputs, input_xml_path: Optional[str] = None,
               input_logit_path: Optional[str] = None) -> List[List[str]]:
    """The stage-by-stage loop: one page at a time, the next decoded on
    a worker thread.  Returns each page's transcription lines."""
    results = []
    with stage_timer("cli/pages"):
        prefetcher = ImagePrefetcher(input_image_path, images_to_process)
        for index, file_id in enumerate(ids_to_process):
            results.append(process_one(page_parser, prefetcher.get(), file_id, index,
                                       len(ids_to_process), outputs, input_xml_path,
                                       input_logit_path))
    return results


if __name__ == "__main__":
    main()
