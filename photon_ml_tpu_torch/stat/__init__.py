"""Per-feature summary statistics (``summary.summarize``)."""
