from pero_ocr_tpu_torch.document.page_parser import *  # noqa: F401,F403
from pero_ocr_tpu_torch.document.page_parser import (  # noqa: F401
    PageParser,
    PageDecoder,
    PageOCR,
    LineCropper,
    WholePageRegion,
    layout_parser_factory,
    line_cropper_factory,
    ocr_factory,
    page_decoder_factory,
)
