"""pivot_entry_scan_roofline.gist: percent of its roofline that `pivot_entry_scan` reached in the
traced stretch (`peaks.roofline_share`, work from `roofline/pivot_entry_scan.py`); at D 960
the kernel streams its queries through the ring beside the pivot chunks."""

from portbench.peaks import roofline_share


ROOFLINES = ("pivot_entry_scan",)  # the kernel calls this reads


def read(run):
    return roofline_share(run, "pivot_entry_scan")
