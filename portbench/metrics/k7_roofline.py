"""K7's share of its roofline: 2 db K (3 rows_student + rows_teacher) flops
at the bf16 peak, or its bytes, over its device time."""


def read(t):
    return t.roofline("k7")
