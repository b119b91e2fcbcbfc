"""Model pipelines: featurizers + model, with MLflow-style flavor metadata.

A *model pipeline* is what the paper deploys into the RDBMS: preprocessing
steps plus a trained model, packaged in a portable format (paper: MLflow/ONNX).
Our pipelines are the objects the static analyzer (`core.pipeline_frontend`)
traces into Raven IR, and the objects the model store versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..relational.table import resolve_device
from .featurize import FeatureMapping

__all__ = ["Pipeline", "PipelineMetadata"]

# model kinds whose ``fit`` trains on a device (the others are numpy CART)
_TENSOR_FITS = ("linear_regression", "logistic_regression", "mlp")


@dataclasses.dataclass
class PipelineMetadata:
    """MLflow-flavor-like metadata accompanying a pipeline (§3.2: scripts are
    'accompanied by metadata to specify the required runtimes and
    dependencies')."""

    name: str
    flavor: str = "repro.native"       # native | external | container
    python_version: str = "3.11"
    dependencies: tuple = ()
    signature_inputs: tuple = ()       # required input column names
    task: str = "classification"


class Pipeline:
    """featurizers -> model.  ``featurizers`` run in declaration order and
    their outputs are concatenated into the feature matrix."""

    def __init__(self, featurizers: Sequence[Any], model: Any,
                 metadata: Optional[PipelineMetadata] = None):
        self.featurizers = list(featurizers)
        self.model = model
        self.metadata = metadata or PipelineMetadata(name="anonymous")

    # -- schema ------------------------------------------------------------
    def feature_mapping(self) -> FeatureMapping:
        names: List[str] = []
        source: List[str] = []
        category: List[int] = []
        for f in self.featurizers:
            m = f.mapping()
            names += m.names
            source += m.source
            category += m.category
        return FeatureMapping(names, source, category)

    def input_columns(self) -> List[str]:
        cols: List[str] = []
        for f in self.featurizers:
            for c in f.mapping().source:
                if c not in cols:
                    cols.append(c)
        return cols

    # -- fit / transform -----------------------------------------------------
    def fit(self, data: Dict[str, np.ndarray], y: np.ndarray, *,
            device: Any = None) -> "Pipeline":
        """Fit the featurizers (numpy), then the model on the featurized
        data.  Linear and MLP models train with ``torch.autograd`` on
        ``device`` (``None`` is the card; pass ``"cpu"`` on a CPU box), the
        features computed there; tree models keep their numpy CART fit on
        the host."""
        for f in self.featurizers:
            f.fit(data)
        on_device = self.model.kind in _TENSOR_FITS
        dev = resolve_device(device) if on_device else torch.device("cpu")
        x = self.transform(
            {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
             for k, v in data.items()})
        self.model.fit(x if on_device else x.numpy(), y,
                       feature_names=self.feature_mapping().names)
        return self

    def transform(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = [f.transform(columns) for f in self.featurizers]
        return torch.cat(feats, dim=1)

    def predict(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model.predict(self.transform(columns))

    def predict_scores(self, columns: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        x = self.transform(columns)
        if hasattr(self.model, "predict_scores"):
            return self.model.predict_scores(x)
        if hasattr(self.model, "decision_function"):
            return self.model.decision_function(x)[:, None]
        return self.model.predict(x)[:, None]
