"""Import-path alias, as the JAX package's ``document_ocr``: the
reference exposes its pipeline as ``pero_ocr.document_ocr``, so code
written for it keeps its module layout
(``pero_ocr_tpu_torch.document_ocr.page_parser.PageParser``)."""

from pero_ocr_tpu_torch.document import page_parser, pdf  # noqa: F401
from pero_ocr_tpu_torch.document.page_parser import PageParser  # noqa: F401
