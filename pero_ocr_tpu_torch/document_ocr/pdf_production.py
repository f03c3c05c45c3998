from pero_ocr_tpu_torch.document.pdf import *  # noqa: F401,F403
from pero_ocr_tpu_torch.document.pdf import Merger, SearchablePDFWriter  # noqa: F401
