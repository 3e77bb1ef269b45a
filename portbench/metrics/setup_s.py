"""setup_s (s, lower is better; host clock): from the harness's start to
the window's opening: imports, the program's kernels and host runtime
loaded (built, in a checkout's first run), the codec, the inputs made
from the seed, and the warm-up."""


def read(run):
    return run.setup_s
