from .csr import CsrFlashMatrix, fill_row_blocks
from .csrcsc import csrcsc, csrcsc_scratch
from .csrgemv import csrgemv, csrgemv_in_mem
from .csrmm import csrmm, csrmm_in_mem

__all__ = ["CsrFlashMatrix", "fill_row_blocks", "csrcsc", "csrcsc_scratch",
           "csrgemv", "csrgemv_in_mem", "csrmm", "csrmm_in_mem"]
