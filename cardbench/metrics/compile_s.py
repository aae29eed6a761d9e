"""Seconds of the compiler (``build_lm_graph`` and ``optimize``, or the
serve driver's ``fetch_plan``) in set-up, by the host clock."""


def read(run):
    return run.rec.get("compile_s")
