"""Device milliseconds per train step in the `batch norm` category of the
trace's kernels: cuDNN's and ATen's normalisation kernels, and the
Welford kernel of the float32 statistics that `var_mean` takes (its name
holds `welford`, which the category's pattern matches). The frozen
encoders' BatchNorm layers are its only source; a step without them
reads nothing."""

UNIT = "ms/step"
MOVES = "train_samples_per_s.fusion"


def read(run):
    if run.job != "train" or run.trace is None:
        return None
    us = run.trace.category_us().get("batch norm")
    if not us:
        return None
    return us / 1e3 / run.trace.units
