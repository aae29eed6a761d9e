"""Milliseconds a decode step of the whole batch, its logits on the
host (``ServeReport.decode_s`` over ``steps``)."""


def read(run):
    steps = run.rec.get("steps")
    return 1e3 * run.rec["decode_s"] / steps if steps else None
