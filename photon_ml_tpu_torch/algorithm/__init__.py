"""GAME coordinates and block coordinate descent."""
