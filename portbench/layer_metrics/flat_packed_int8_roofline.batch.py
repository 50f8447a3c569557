"""flat_packed_int8_roofline.batch: percent of its roofline that `flat_packed_int8` reached in the
traced stretch (`peaks.roofline_share`, work from `roofline/flat_packed_int8.py`)."""

from portbench.peaks import roofline_share


ROOFLINES = ("flat_packed_int8",)  # the kernel calls this reads


def read(run):
    return roofline_share(run, "flat_packed_int8")
