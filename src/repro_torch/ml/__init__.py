"""Classical ML operators + featurizers + NN translation (MLD layer)."""

from .featurize import (Bucketizer, FeatureMapping, Imputer, OneHotEncoder,
                        StandardScaler)
from .hummingbird import (EnsembleGemm, TreeGemm, ensemble_to_gemm,
                          ensemble_to_gemm_mxu, predict_ensemble_gemm,
                          predict_gemm, tree_to_gemm)
from .linear import LinearRegression, LogisticRegression
from .mlp import MLP
from .pipeline import Pipeline, PipelineMetadata
from .tree import (DecisionTree, GradientBoostedTrees, RandomForest,
                   TreeArrays, fit_tree_arrays)

__all__ = [
    "Bucketizer", "FeatureMapping", "Imputer", "OneHotEncoder",
    "StandardScaler",
    "EnsembleGemm", "TreeGemm", "ensemble_to_gemm", "ensemble_to_gemm_mxu",
    "predict_ensemble_gemm", "predict_gemm", "tree_to_gemm",
    "LinearRegression", "LogisticRegression", "MLP",
    "Pipeline", "PipelineMetadata",
    "DecisionTree", "GradientBoostedTrees", "RandomForest", "TreeArrays",
    "fit_tree_arrays",
]
