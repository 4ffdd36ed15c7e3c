"""Share of their least time that the fixed-effect kernels' launches took on
the card: Σ least time of every csr_matvec_f32 and csc_rmatvec_f32 launch
at its shape (``roofline.py``) over their device time in the trace, merge
kernels, carry rounds and block sums together. Moves ``train_s``."""


def read(r):
    return r.roofline(("csr_matvec_f32", "csc_rmatvec_f32"))
