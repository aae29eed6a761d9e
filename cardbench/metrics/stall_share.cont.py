"""Percent of the window's requests' time from first token to last
that admission rounds held them: the sum of ``Request.stall_s`` over
the sum of ``t_done - t_first``.  ``None`` where the program's requests
keep no stall counter."""


def read(run):
    reqs = run.state.get("requests") or []
    if not reqs or not hasattr(reqs[0], "stall_s"):
        return None
    held = sum(r.t_done - r.t_first for r in reqs)
    return 100.0 * sum(r.stall_s for r in reqs) / held if held else None
