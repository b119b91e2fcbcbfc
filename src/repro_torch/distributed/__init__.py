"""The distributed substrate the training path reaches: gradient
compression and checkpoint-restart supervision."""

from .compression import (compress_tree, dequantize_int8,
                          make_error_feedback_compressor, quantize_int8)
from .fault_tolerance import FailureInjector, RestartableRunner

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "make_error_feedback_compressor", "FailureInjector",
           "RestartableRunner"]
