from pero_ocr_tpu_torch.decoding.bag_of_hypotheses import BagOfHypotheses  # noqa: F401
from pero_ocr_tpu_torch.decoding.decoders import (  # noqa: F401
    BLANK_SYMBOL,
    CTCPrefixLogRawNumpyDecoder,
    GreedyDecoder,
)
