"""Process start to the first timed batch: imports, weights, packing and
quantization, kernel build or load, and the warm-up batch."""


def read(run):
    return run.setup_s
