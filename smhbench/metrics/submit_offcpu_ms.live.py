"""Wall time less the thread's CPU time of the submit half's pack and
dispatch (vision.load_frame + vision.dispatch), mean per submit in the
window (ms): time the submit thread waited for a core, the interpreter
or the CUDA runtime."""

from smhbench import spans


def read(run):
    return spans.per_submit_ms(run, ("vision.load_frame", "vision.dispatch"), offcpu=True)
