"""setup_s: seconds from process start to the first timed batch or step:
imports, the kernel libraries (built by nvcc on a checkout's first run;
the result line gives that load apart as ``compile_s``, with the names
nvcc built as ``nvcc_built``), weights, the frames or the data feed, and
the warm-up."""


def read(rec):
    return rec["setup_s"]
