"""The first frame (or batch) of the process: its submit's start to the end
of its fetch wait (s), the backend's creation and the kernels' load inside."""

from smhbench import spans


def read(run):
    return spans.setup_first_pass_s(run)
