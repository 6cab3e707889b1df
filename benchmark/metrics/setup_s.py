"""Process start to the first timed call: CUDA start, the library's load
or build, the inputs, the program's problems and the warm-up calls."""


def read(run):
    return run.setup_s
