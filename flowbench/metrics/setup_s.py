"""Process start to the first timed step: imports, the kernels' library
built or loaded, the frame ring, the operators, the capture and the
warm-up."""


def read(record: dict):
    return record["setup_s"]
