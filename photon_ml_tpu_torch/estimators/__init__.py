"""Estimators: random-effect training and the GAME estimator."""
