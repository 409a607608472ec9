"""Process start to window start: imports, kernels from the build
cache, weights, the stack, the warm-up request and the warm phase."""


def read(data):
    return data.setup_s
