"""Device idle milliseconds a prefill: the traced window's idle gaps (no
device operation running) inside the windows of the port timer
``serve/prefill`` in the program's span log (``spans.idle_inside_s``), over
the number of those windows: the time a prefill's card waits for the host."""

from portbench.spans import idle_inside_s


def read(ctx):
    got = idle_inside_s(ctx, "serve/prefill")
    if got is None or got[1] == 0:
        return None
    seconds, prefills = got
    return 1e3 * seconds / prefills
