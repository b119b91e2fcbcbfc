"""Median over the executions begun in the window of the linear model's
device time: the summed ``device_ms`` of the ``op.matmul_bias`` spans
under each ``execute`` span, read as ``featurize_device_ms.p50`` reads
the featurizers'."""

from raven_bench.harness import layout


def read(run):
    return layout.module("metrics", "featurize_device_ms.p50").device_ms(
        run, "op.matmul_bias")
