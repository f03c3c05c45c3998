"""Convert a torch char-LSTM language model checkpoint to the LM format
of the ``[DECODER] LM`` key (flax msgpack variables and a JSON sidecar
spec): the port of scripts/convert_torch_lm.py, with its arguments,
output files and printed line.

    python3 -m pero_ocr_tpu_torch.scripts.convert_torch_lm model.pt out.lm \\
        [--embed-prefix embed] [--lstm-prefix lstm] [--head-prefix head] \\
        [--vocab-json chars.json]

The msgpack bytes are those of flax's ``to_bytes`` (the port's own
writer, :func:`pero_ocr_tpu_torch.utils.checkpoint.save_variables`).
"""

from __future__ import annotations

import argparse
import json

import torch

from pero_ocr_tpu_torch.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.utils.convert import convert_torch_lm, lm_spec_from_variables


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("torch_checkpoint", help=".pt state dict or module")
    parser.add_argument("output", help="output LM path (msgpack)")
    parser.add_argument("--embed-prefix", default="embed")
    parser.add_argument("--lstm-prefix", default="lstm")
    parser.add_argument("--head-prefix", default="head")
    parser.add_argument("--vocab-json", default=None,
                        help="optional JSON list of LM vocabulary chars")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    obj = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
    variables = convert_torch_lm(state_dict, embed_prefix=args.embed_prefix,
                                 lstm_prefix=args.lstm_prefix, head_prefix=args.head_prefix)
    sidecar = lm_spec_from_variables(variables)
    save_variables(variables, args.output)
    if args.vocab_json:
        with open(args.vocab_json, encoding="utf8") as f:
            chars = json.load(f)
        sidecar["vocab"] = {c: i for i, c in enumerate(chars)}
    with open(args.output + ".json", "w", encoding="utf8") as f:
        json.dump(sidecar, f)
    print("converted: vocab={vocab_size} embed={embed_dim} hidden={hidden_dim} "
          "layers={num_layers} -> ".format(**sidecar) + args.output)


if __name__ == "__main__":
    main()
