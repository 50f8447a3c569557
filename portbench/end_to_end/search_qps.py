"""search_qps: queries answered over the whole window: every query of
every call sent in the window and answered, over the time from the
window's start to the last answer."""

from portbench.stats import completed_rate


def read(run):
    rec = run.records
    return completed_rate(float(rec["query_ok"].sum()), rec["t0"], rec["done"])
