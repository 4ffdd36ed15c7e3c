"""Share of their least time that the batched value+gradient kernel's
launches (fused_value_grad_batched_f32, each at its bucket's [E, s, d])
took on the card. Moves ``train_s``."""


def read(r):
    return r.roofline(("fused_value_grad_batched_f32",))
