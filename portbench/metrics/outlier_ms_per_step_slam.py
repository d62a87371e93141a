"""Device ms a SLAM step of the statistical outlier filter
(`ops/outliers.statistical_outlier_mask`: the Gram product, the top-k and
its passes): the interval of the program's ``slam.outlier`` span on the
device less the idle inside it (`_spans.busy_ms_per_call`), over the
traced steps."""

from portbench.metrics._spans import busy_ms_per_call


def read(ctx):
    return busy_ms_per_call(ctx, "slam", "slam.outlier")
