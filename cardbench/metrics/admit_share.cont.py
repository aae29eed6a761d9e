"""Percent of the batcher's time spent admitting: the prefill side
steps, token by token (``ServeReport.prefill_s`` over ``wall_s``)."""


def read(run):
    wall = run.rec.get("serve_wall_s")
    return 100.0 * run.rec["prefill_s"] / wall if wall else None
