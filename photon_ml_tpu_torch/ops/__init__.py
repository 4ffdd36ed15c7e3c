"""Feature layouts, their linear maps, and the hand-written kernels
(sources under ``ops/csrc``)."""
