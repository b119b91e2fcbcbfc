"""Distribution: sharding rules, gradient compression, elastic
rescaling and checkpoint-restart supervision."""

from .compression import (compress_tree, dequantize_int8,
                          make_error_feedback_compressor, quantize_int8)
from .elastic import RescalePlan, plan_rescale, rescale_state
from .fault_tolerance import FailureInjector, RestartableRunner
from .sharding import (Placement, activation_specs, data_axes_of, gather,
                       logical_to_pspec, place, serve_rules, train_rules,
                       tree_pspecs, tree_shardings)

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "make_error_feedback_compressor", "FailureInjector",
           "RestartableRunner", "Placement", "train_rules", "serve_rules",
           "logical_to_pspec", "tree_pspecs", "tree_shardings",
           "activation_specs", "data_axes_of", "place", "gather",
           "RescalePlan", "plan_rescale", "rescale_state"]
