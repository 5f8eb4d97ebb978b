"""Lanes the exact router sent to the two-phase fallback, mean over the
window's calls (``info["fallback"]``)."""


def read(run):
    vals = [i["fallback"] for i in run.infos if "fallback" in i]
    return sum(vals) / len(vals) if vals else None
