"""Percent of the slots a decode step fills, averaged over the
window's decode steps (``ServeReport.occupancy``)."""


def read(run):
    occ = run.rec.get("occupancy")
    return None if occ is None else 100.0 * occ
