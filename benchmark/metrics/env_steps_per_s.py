"""Lane-steps completed in the window over the window's seconds (host clock,
from the synchronize that opens the window to the one that closes it)."""


def read(run):
    return run.steps * run.batch / run.window_s
