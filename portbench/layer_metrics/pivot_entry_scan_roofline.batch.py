"""pivot_entry_scan_roofline.batch: percent of its roofline that `pivot_entry_scan` reached in the
traced stretch (`peaks.roofline_share`, work from `roofline/pivot_entry_scan.py`)."""

from portbench.peaks import roofline_share


ROOFLINES = ("pivot_entry_scan",)  # the kernel calls this reads


def read(run):
    return roofline_share(run, "pivot_entry_scan")
