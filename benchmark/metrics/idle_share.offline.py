"""Share of the traced slice of offline batches in which no operation ran on the card,
in %, from the session that traces the card alone (the profiler's host cost
there is small; ``idle_share_untraced`` on the run's notes line estimates
the window's own)."""


def read(sl):
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s) if sl.device else None
